// Native host codec: the byte-level hot loops of the storage/wire boundary.
//
// The reference implements its codec surface in Rust (db/vector_quants.rs,
// pql/embedding_utils.rs); here the native tier is C++ behind a C ABI,
// loaded via ctypes (panoptikon_tpu.native). Semantics are bit-identical
// to the NumPy reference implementations in ops/codec.py — the tests
// cross-check them element for element:
//
//   scale = absmax / 127 (unit scale on degenerate corpus)
//   code  = clamp(rint(x / s), -128, 127)   round-half-to-even, NaN -> 0
//
// Build: `make -C panoptikon_tpu/native` -> libpanoptikon_native.so.

#include <cfenv>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Largest |x| over n floats; NaN never wins the comparison.
float pk_absmax(const float* data, int64_t n) {
    float absmax = 0.0f;
    for (int64_t i = 0; i < n; ++i) {
        float v = std::fabs(data[i]);
        if (v > absmax) absmax = v;  // NaN > x is false, so NaN is skipped
    }
    return absmax;
}

float pk_scale_from_absmax(float absmax) {
    if (absmax > 0.0f && std::isfinite(absmax)) return absmax / 127.0f;
    return 1.0f;
}

// Quantize n floats to int8 codes under one scale. Round-half-to-even via
// nearbyintf under FE_TONEAREST (the C default), matching np.rint and the
// Rust codec's round_ties_even. NaN maps to 0 (Rust's saturating cast).
void pk_quantize_int8(const float* in, int8_t* out, int64_t n, float scale) {
    // TRUE f32 division, not multiply-by-reciprocal: x * (1/s) differs
    // from x / s by 1 ulp at exactly the .5 rounding boundaries this
    // codec's bit-identity contract cares about.
    for (int64_t i = 0; i < n; ++i) {
        float v = in[i] / scale;
        if (std::isnan(v)) {
            out[i] = 0;
            continue;
        }
        float r = std::nearbyintf(v);
        if (r <= -128.0f) out[i] = -128;
        else if (r >= 127.0f) out[i] = 127;
        else out[i] = static_cast<int8_t>(r);
    }
}

void pk_dequantize_int8(const int8_t* in, float* out, int64_t n, float scale) {
    for (int64_t i = 0; i < n; ++i) out[i] = static_cast<float>(in[i]) * scale;
}

// Per-row sum of squares of int8 codes: rows x dim -> int32 per row.
void pk_row_sumsq_int8(const int8_t* codes, int32_t* out, int64_t rows,
                       int64_t dim) {
    for (int64_t r = 0; r < rows; ++r) {
        int32_t acc = 0;
        const int8_t* p = codes + r * dim;
        for (int64_t j = 0; j < dim; ++j) {
            int32_t v = p[j];
            acc += v * v;
        }
        out[r] = acc;
    }
}

// splitmix64 finalizer + pk_mix (db/sql_functions.rs semantics), vectorized
// over an id array for host-side random-order key generation.
static inline uint64_t mix64(uint64_t z) {
    z += 0x9E3779B97F4A7C15ull;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
}

void pk_mix_array(const int64_t* ids, int64_t* out, int64_t n, int64_t seed) {
    const uint64_t mixed_seed = mix64(static_cast<uint64_t>(seed));
    for (int64_t i = 0; i < n; ++i) {
        out[i] = static_cast<int64_t>(
            mix64(static_cast<uint64_t>(ids[i]) ^ mixed_seed));
    }
}

// Length-prefixed frame codec (the inferio worker wire format:
// 4-byte LE u32 length + payload, 2 GiB cap). Returns payload length or
// -1 (short buffer) / -2 (oversized frame).
int64_t pk_frame_decode(const uint8_t* buf, int64_t len, const uint8_t** payload) {
    if (len < 4) return -1;
    uint32_t n;
    std::memcpy(&n, buf, 4);
    if (n > (1u << 31)) return -2;
    if (len < 4 + static_cast<int64_t>(n)) return -1;
    *payload = buf + 4;
    return static_cast<int64_t>(n);
}

void pk_frame_encode_header(uint8_t* out, uint32_t payload_len) {
    std::memcpy(out, &payload_len, 4);
}

}  // extern "C"
