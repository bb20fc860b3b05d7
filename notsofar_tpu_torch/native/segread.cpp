// Native segment reader for the simulated-dataset byte format.
// Copy of notsofar_tpu/native/segread.cpp.
//
// The training input pipeline reads random int16 segments out of large
// column files (notsofar_tpu_torch/training/dataset.py). This kernel performs
// open -> seek -> read -> int16-to-float32 descale in one call with no
// Python-level buffering, so the thread-pool loader scales past the GIL.
//
// Build: make -C notsofar_tpu_torch/native build/libsegread.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// Reads `rows` rows of `row_elems` int16 values starting at row `offset`
// from `path`, writing descaled float32 into out (size rows*row_elems).
// Returns 0 on success, negative errno-style codes on failure.
int read_scaled_segment_i16(const char* path, int64_t offset_rows,
                            int64_t rows, int64_t row_elems, double scale,
                            float* out) {
    FILE* f = std::fopen(path, "rb");
    if (f == nullptr) return -1;
    const int64_t row_bytes = row_elems * 2;
    if (std::fseek(f, static_cast<long>(offset_rows * row_bytes), SEEK_SET)) {
        std::fclose(f);
        return -2;
    }
    const int64_t n = rows * row_elems;
    std::vector<int16_t> buf(n);
    const size_t got = std::fread(buf.data(), 2, n, f);
    std::fclose(f);
    if (static_cast<int64_t>(got) != n) return -3;
    const float inv = static_cast<float>(1.0 / scale);
    for (int64_t i = 0; i < n; ++i) {
        out[i] = buf[i] * inv;
    }
    return 0;
}

// int8 variant (activity scores), raw copy into an int8 buffer.
int read_segment_i8(const char* path, int64_t offset_rows, int64_t rows,
                    int64_t row_elems, int8_t* out) {
    FILE* f = std::fopen(path, "rb");
    if (f == nullptr) return -1;
    const int64_t row_bytes = row_elems;
    if (std::fseek(f, static_cast<long>(offset_rows * row_bytes), SEEK_SET)) {
        std::fclose(f);
        return -2;
    }
    const int64_t n = rows * row_elems;
    const size_t got = std::fread(out, 1, n, f);
    std::fclose(f);
    return static_cast<int64_t>(got) == n ? 0 : -3;
}

}  // extern "C"
