// Native host-side audio ops of the serving path: float -> int16 PCM encode
// and the linear crossfade of two clips (the work between the device's
// output and the response). Built at first use with the host compiler and
// bound with ctypes by f5tts_tpu_torch/audio/native.py; the same source as
// the JAX package's csrc/audioops.cpp, less its unbound rms.
//
// Build: c++ -O3 -shared -fPIC -o libaudioops.so audioops.cpp

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// Encode float32 [-1,1] samples to int16 PCM with clipping.
void encode_pcm16(const float* in, int64_t n, int16_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        float v = in[i];
        if (v > 1.0f) v = 1.0f;
        if (v < -1.0f) v = -1.0f;
        out[i] = (int16_t)lrintf(v * 32767.0f);
    }
}

// Linear crossfade of two clips into dst:
//   dst = [a[0:na-nf] ; a_tail*fade_out + b_head*fade_in ; b[nf:nb]]
// Returns the output length. dst must hold na + nb - nf samples.
int64_t crossfade_pair(const float* a, int64_t na, const float* b, int64_t nb,
                       int64_t nf, float* dst) {
    if (nf > na) nf = na;
    if (nf > nb) nf = nb;
    if (nf <= 0) {
        memcpy(dst, a, sizeof(float) * na);
        memcpy(dst + na, b, sizeof(float) * nb);
        return na + nb;
    }
    int64_t head = na - nf;
    memcpy(dst, a, sizeof(float) * head);
    // the endpoints of numpy.linspace(1, 0, nf): denominator nf - 1; the
    // fade-out is 1 - fade_in, which linspace's own arithmetic differs from
    // by up to an ulp at some samples
    const float denom = nf > 1 ? (float)(nf - 1) : 1.0f;
    for (int64_t i = 0; i < nf; ++i) {
        float fade_in = (float)i / denom;
        float fade_out = 1.0f - fade_in;
        dst[head + i] = a[head + i] * fade_out + b[i] * fade_in;
    }
    memcpy(dst + na, b + nf, sizeof(float) * (nb - nf));
    return na + nb - nf;
}

}  // extern "C"
