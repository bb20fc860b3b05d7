// Monotonic DTW for whisper word-timestamp alignment.
//
// Copy of notsofar_tpu/native/dtw.cpp, used by the port's word timings
// (notsofar_tpu_torch/asr/decoding.py::dtw_path, loaded by ctypes). One
// change departs from that file, the cost's element type: it is read as
// double, not float, and the caller upcasts to float64 before the call.
// That upcast is the one the port's numpy DP (decoding.py::
// _dtw_path_numpy) makes, so the path is the numpy DP's bit for bit for
// float32 and float64 costs alike.
//
// Exact port of the numpy reference DP (itself matching openai-whisper
// timing.dtw semantics): allowed moves are diagonal / up / left with tie
// order diagonal <= up < left, traceback from the far corner. The matrices
// are ~[n_tokens, 1500] per 30 s window; on one x86 core the numpy DP
// takes ~100 ms a [150, 1500] window, this kernel ~1.5 ms. Costs
// accumulate in double.
//
// Build: at first use, by utils/native.py::load_native("dtw").
#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// cost: [N, M] row-major float64. text_idx/time_idx: caller-allocated
// int32 buffers of capacity N + M. Returns the path length.
int64_t dtw_path(const double* cost, int64_t N, int64_t M,
                 int32_t* text_idx, int32_t* time_idx) {
    const double INF = std::numeric_limits<double>::infinity();
    std::vector<double> prev(M + 1, INF), cur(M + 1, INF);
    std::vector<int8_t> trace((N + 1) * (M + 1), 0);
    prev[0] = 0.0;
    for (int64_t i = 1; i <= N; ++i) {
        cur[0] = INF;
        const double* crow = cost + (i - 1) * M;
        int8_t* trow = trace.data() + i * (M + 1);
        for (int64_t j = 1; j <= M; ++j) {
            const double c0 = prev[j - 1], c1 = prev[j], c2 = cur[j - 1];
            double cmin;
            int8_t t;
            if (c0 <= c1 && c0 <= c2) { cmin = c0; t = 0; }
            else if (c1 < c2)         { cmin = c1; t = 1; }
            else                      { cmin = c2; t = 2; }
            cur[j] = crow[j - 1] + cmin;
            trow[j] = t;
        }
        std::swap(prev, cur);
    }
    int64_t i = N, j = M, n = 0;
    while (i > 0 && j > 0) {
        text_idx[n] = (int32_t)(i - 1);
        time_idx[n] = (int32_t)(j - 1);
        ++n;
        const int8_t t = trace[i * (M + 1) + j];
        if (t == 0)      { --i; --j; }
        else if (t == 1) { --i; }
        else             { --j; }
    }
    // reverse in place to chronological order
    for (int64_t a = 0, b = n - 1; a < b; ++a, --b) {
        int32_t tmp = text_idx[a]; text_idx[a] = text_idx[b]; text_idx[b] = tmp;
        tmp = time_idx[a]; time_idx[a] = time_idx[b]; time_idx[b] = tmp;
    }
    return n;
}

}  // extern "C"
