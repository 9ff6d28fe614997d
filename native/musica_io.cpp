// Native IO codec for the MUSICA framework (build: make -C native).
//
// Covers the reference's host-side file layer with a multithreaded C++
// implementation (reference: src/file.cpp readFile/writeFile, the standalone
// raw de-interleave at test/standalone/main.cpp:57-75, and the stb BMP write
// at src/vk_processing.cpp:2636):
//
//   * musica_read_raw16  -- 256-byte-header little-endian uint16 raw load,
//                           optional transpose (the CLI's pixels[x*n+y]);
//   * musica_write_bmp8  -- 24-bit BMP (stb expands 1 channel to BGR);
//   * musica_read_raw16_batch -- threaded batch loader for the data pipeline.
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// Returns 0 on success.
int musica_read_raw16(const char* path, int size, int header_bytes,
                      uint16_t* out, int transpose) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    if (std::fseek(f, 0, SEEK_END) != 0) { std::fclose(f); return 2; }
    long fsize = std::ftell(f);
    const long expected = (long)header_bytes + 2L * size * size;
    if (fsize != expected) { std::fclose(f); return 3; }
    if (std::fseek(f, header_bytes, SEEK_SET) != 0) { std::fclose(f); return 2; }

    std::vector<uint8_t> buf((size_t)2 * size * size);
    if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
        std::fclose(f);
        return 4;
    }
    std::fclose(f);

    // little-endian decode; transpose reproduces the reference CLI's
    // pixels[x * size + y] de-interleave of the row-major stream
    const uint8_t* p = buf.data();
    if (transpose) {
        // blocked transpose for cache friendliness
        const int B = 64;
        for (int xb = 0; xb < size; xb += B) {
            int xe = xb + B < size ? xb + B : size;
            for (int yb = 0; yb < size; yb += B) {
                int ye = yb + B < size ? yb + B : size;
                for (int x = xb; x < xe; x++) {
                    const uint8_t* row = p + (size_t)2 * x * size;
                    for (int y = yb; y < ye; y++) {
                        out[(size_t)y * size + x] =
                            (uint16_t)(row[2 * y] | (row[2 * y + 1] << 8));
                    }
                }
            }
        }
    } else {
        for (size_t i = 0; i < (size_t)size * size; i++) {
            out[i] = (uint16_t)(p[2 * i] | (p[2 * i + 1] << 8));
        }
    }
    return 0;
}

int musica_write_raw16(const char* path, const uint16_t* data, int size,
                       int header_bytes) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return 1;
    std::vector<uint8_t> header((size_t)header_bytes, 0);
    if (header_bytes &&
        std::fwrite(header.data(), 1, header.size(), f) != header.size()) {
        std::fclose(f);
        return 2;
    }
    std::vector<uint8_t> buf((size_t)2 * size * size);
    for (size_t i = 0; i < (size_t)size * size; i++) {
        buf[2 * i] = (uint8_t)(data[i] & 0xff);
        buf[2 * i + 1] = (uint8_t)(data[i] >> 8);
    }
    size_t n = std::fwrite(buf.data(), 1, buf.size(), f);
    std::fclose(f);
    return n == buf.size() ? 0 : 2;
}

// 24-bit bottom-up BGR BMP of a single-channel u8 image [h rows, w cols].
int musica_write_bmp8(const char* path, const uint8_t* data, int w, int h) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return 1;
    const int row_bytes = w * 3;
    const int pad = (4 - (row_bytes % 4)) % 4;
    const uint32_t data_size = (uint32_t)(row_bytes + pad) * h;
    const uint32_t off = 14 + 40;
    uint8_t hdr[54] = {0};
    hdr[0] = 'B'; hdr[1] = 'M';
    uint32_t fsz = off + data_size;
    std::memcpy(hdr + 2, &fsz, 4);
    std::memcpy(hdr + 10, &off, 4);
    uint32_t ihs = 40; std::memcpy(hdr + 14, &ihs, 4);
    std::memcpy(hdr + 18, &w, 4);
    std::memcpy(hdr + 22, &h, 4);
    uint16_t planes = 1, bpp = 24;
    std::memcpy(hdr + 26, &planes, 2);
    std::memcpy(hdr + 28, &bpp, 2);
    std::memcpy(hdr + 34, &data_size, 4);
    if (std::fwrite(hdr, 1, 54, f) != 54) { std::fclose(f); return 2; }

    std::vector<uint8_t> row((size_t)row_bytes + pad, 0);
    for (int y = h - 1; y >= 0; y--) {
        const uint8_t* src = data + (size_t)y * w;
        for (int x = 0; x < w; x++) {
            row[3 * x] = row[3 * x + 1] = row[3 * x + 2] = src[x];
        }
        if (std::fwrite(row.data(), 1, row.size(), f) != row.size()) {
            std::fclose(f);
            return 2;
        }
    }
    std::fclose(f);
    return 0;
}

// Threaded batch raw loader: paths are '\n'-joined; outputs are contiguous
// [count, size, size].  Returns 0 if every file loaded.
int musica_read_raw16_batch(const char* joined_paths, int count, int size,
                            int header_bytes, uint16_t* out, int transpose,
                            int n_threads) {
    std::vector<std::string> paths;
    {
        const char* s = joined_paths;
        for (int i = 0; i < count; i++) {
            const char* e = std::strchr(s, '\n');
            if (!e) e = s + std::strlen(s);
            paths.emplace_back(s, e - s);
            s = (*e == '\n') ? e + 1 : e;
        }
    }
    if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads > count) n_threads = count;
    std::vector<int> rcs(count, 0);
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; t++) {
        threads.emplace_back([&, t]() {
            for (int i = t; i < count; i += n_threads) {
                rcs[i] = musica_read_raw16(
                    paths[i].c_str(), size, header_bytes,
                    out + (size_t)i * size * size, transpose);
            }
        });
    }
    for (auto& th : threads) th.join();
    for (int rc : rcs) if (rc) return rc;
    return 0;
}

}  // extern "C"
