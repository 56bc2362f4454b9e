// Decode-step attention for Hopper (sm_90a): one query position per row
// against a KV cache, grouped-query heads sharing their K/V reads.
//
// Replaces f5tts_tpu/ops/pallas/decode_attention.py:decode_attention (kernel
// _decode_attn_kernel). For each batch row, KV head and group member:
//   s = q . K^T + bias          fp32, over all `total` cache positions
//   p = exp(s - max) / max(sum, 1e-30)   fp32, then rounded to the cache dtype
//   o = p . V                   fp32 accumulation, written in q's dtype
// q arrives pre-scaled by head_dim^-0.5; bias is additive (0 / -1e9).
//
// Bound: bytes. A length-1 query is a matrix-vector product: 2 FLOP per cache
// element read, far below the card's ~295 FLOP/byte ridge, so the least time
// is K and V read once (2 * b * n_kv * total * d elements) over the memory
// rate; tensor cores have nothing to add.
//
// Design, against that bound:
// - a thread-block cluster of `split` blocks (at most 8, the portable size)
//   per (kv head, batch row, tile of GT group members); block `rank` owns the
//   positions [rank * span, (rank + 1) * span). The wrapper picks the split
//   from the shape (ops/kernels/decode_attention.py:decode_split): enough
//   blocks for ~2 per SM (at b = 1 a cluster of 8 per head), none shorter
//   than 48 positions.
// - in a contiguous (b, n_kv, total, d) cache a block's span of K (or V) is
//   one contiguous byte range: it is streamed in chunks of 32 positions by
//   1-D bulk copies (cp.async.bulk, no tensor map) into rings of shared-memory
//   slots, each completing on its own mbarrier. K's ring (32 KB) is issued at
//   the start and refilled by the warp that has just read a slot; V chunk c is
//   issued as soon as K chunk c has been read, so V is in flight through the
//   score pass and the softmax and queues behind the K it must not delay. V's
//   ring holds the whole span when the block's share of an SM allows (the
//   grid sized to run in one wave), else it is refilled in the PV pass.
// - score pass: one lane per position of a staged K chunk, the dot product
//   over d in fp32 with the 16-byte vectors taken in a lane-rotated order (at
//   d 64 bf16 the rows are 128 bytes apart, so without the rotation every lane
//   would hit the same banks); no shuffles per score. Scores go to shared memory, beside the
//   span's bias, staged at the start.
// - each block pushes its (max, sum of exp(s - max)) into every block of the
//   cluster (mapa + st.shared::cluster, one barrier.cluster arrive.release /
//   wait.acquire); each then has the row's max and sum (ranks in order), so
//   p = exp(s - max) / sum is rounded to the cache dtype only once the whole
//   row's sum is known, as in the plain version, in one launch.
// - PV pass: 16-byte V vectors by neighbouring lanes (a warp reads whole
//   rows), fp32 accumulators in registers, reduced across the warp's row
//   groups and the block's warps once at the end; each block pushes its
//   partial row into rank 0, which sums them in rank order and writes o.
// - a fully masked row (every bias -1e9) collapses to s = -1e9 everywhere in
//   fp32, so p is uniform over the `total` positions given: the same as the
//   plain version on an unpadded cache.
// What holds it back (PERF.md): the loads, which no copy schedule tried took
// to the bound, and the work after the last K chunk (the exchange, then P V,
// which must wait for the row's sum), a tail the loads cannot hide.

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = f5::hopper;
using bf16 = __nv_bfloat16;
using f5::from_f;
using f5::rnd;

constexpr int NW = 4;  // warps per block
constexpr int NTHREADS = NW * 32;
constexpr int CH = 32;  // positions per bulk copy: one per lane in the score pass
constexpr int MAX_CLUSTER = 8;
constexpr int K_RING = 32 * 1024;   // bytes of K a block stages at most (refilled as it is read)
constexpr int V_RING = 128 * 1024;  // bytes of V a block stages at most (its share of the SM permitting)
constexpr int MAX_SMEM = 232448 - 1024;  // bytes of dynamic shared memory a block may ask for on sm_90
constexpr int SM_SMEM = 233472;     // bytes of shared memory an SM has for its blocks (1 KB of each block's kept)

// 16-byte vector of T in shared memory, unpacked to floats.
template <typename T> struct Vec;
template <> struct Vec<float> {
    static constexpr int E = 4;
    static __device__ __forceinline__ void load(const float* p, float (&out)[4]) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    }
};
template <> struct Vec<bf16> {
    static constexpr int E = 8;
    static __device__ __forceinline__ void load(const bf16* p, float (&out)[8]) {
        const uint4 raw = *reinterpret_cast<const uint4*>(p);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            out[2 * i] = f.x;
            out[2 * i + 1] = f.y;
        }
    }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

__host__ __device__ constexpr int group_tile(int group) { return group == 1 ? 1 : (group == 2 ? 2 : 4); }

// Ring slots for a span of `chunks` chunks within `budget` bytes (at least
// one): all of them when they fit, each copy issued at the start; else the
// warp that has read chunk c refills its slot with chunk c + slots. Slot s
// belongs to warp s % NW, which reads its chunks in order, so the parity of
// the slot's barrier tells one refill from the next.
template <typename T, int D>
__host__ __device__ inline int ring_slots(int chunks, int budget) {
    const int most = budget / (CH * D * (int)sizeof(T)) > 0 ? budget / (CH * D * (int)sizeof(T)) : 1;
    return chunks <= most ? chunks : most;
}

// Byte offsets of a block's shared memory (all but the barriers 16-byte aligned).
struct Smem {
    uint32_t kring, vring, qs, bias, S, red, stats, pall, wmax, wsum, bars, bytes;
};
template <typename T, int D, int GT>
__host__ __device__ inline Smem smem_layout(int span, int kslots, int vslots, int split) {
    constexpr uint32_t CHB = CH * D * sizeof(T);
    Smem s;
    uint32_t off = 0;
    s.kring = off; off += kslots * CHB;
    s.vring = off; off += vslots * CHB;
    s.qs = off; off += GT * D * sizeof(T);              // q rows (a multiple of 64 bytes)
    s.bias = off; off += (span + 3) / 4 * 4 * 4;        // the span's bias
    s.S = off; off += GT * ((span + 3) / 4 * 4) * 4;    // scores, then p
    s.red = off; off += NW * GT * D * 4;                // per-warp partial o
    s.stats = off; off += split * GT * 2 * 4;           // every block's (max, sum of exp(s - max)), pushed to all
    s.pall = off; off += split * GT * D * 4;            // every block's partial o, pushed to rank 0
    s.wmax = off; off += NW * GT * 4;                   // per-warp max
    s.wsum = off; off += NW * GT * 4;                   // per-warp sum
    off = (off + 7) / 8 * 8;
    s.bars = off; off += (kslots + vslots) * 8;         // K then V slot barriers
    s.bytes = off;
    return s;
}

// q, o: (b, h, d); k, v: (b, n_kv, total, d); bias: (b, total) fp32.
// grid (n_kv * split, b, ceil(group / GT)) in clusters of (split, 1, 1),
// NTHREADS threads, smem_layout(span, kslots, vslots, split).bytes of dynamic
// shared memory.
template <typename T, int D, int GT>
__global__ void __launch_bounds__(NTHREADS)
decode_attn(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const float* __restrict__ bias, T* __restrict__ o, int h, int n_kv, int total, int split, int span,
            int kslots, int vslots) {
    constexpr int E = Vec<T>::E;    // elements per 16-byte vector
    constexpr int NV = D / E;       // vectors per cache row
    constexpr int RPW = 32 / NV;    // cache rows a warp reads per step of the PV pass
    constexpr uint32_t CHB = CH * D * sizeof(T);
    static_assert(NV >= 1 && NV <= 32 && 32 % NV == 0, "head dim must tile a warp");

    extern __shared__ __align__(128) unsigned char smem[];
    const Smem L = smem_layout<T, D, GT>(span, kslots, vslots, split);
    unsigned char* kring = smem + L.kring;
    unsigned char* vring = smem + L.vring;
    T* qs = reinterpret_cast<T*>(smem + L.qs);
    float* bsm = reinterpret_cast<float*>(smem + L.bias);
    float* S = reinterpret_cast<float*>(smem + L.S);
    float* red = reinterpret_cast<float*>(smem + L.red);
    float* stats = reinterpret_cast<float*>(smem + L.stats);
    float* pall = reinterpret_cast<float*>(smem + L.pall);
    float* wmax = reinterpret_cast<float*>(smem + L.wmax);
    float* wsum = reinterpret_cast<float*>(smem + L.wsum);
    uint64_t* kbar = reinterpret_cast<uint64_t*>(smem + L.bars);
    uint64_t* vbar = kbar + kslots;
    const int spanp = (span + 3) / 4 * 4;

    const bool clustered = split > 1;
    if (clustered) hp::cluster_arrive_relaxed();  // waited for before the first store into another block
    const uint32_t rank = clustered ? hp::cluster_rank() : 0;  // == blockIdx.x % split
    const int kvh = blockIdx.x / split, bi = blockIdx.y;
    const int group = h / n_kv;
    const int g0 = blockIdx.z * GT;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int p0 = (int)rank * span;
    const int len = min(total, p0 + span) - p0;  // this block's positions, at least 1
    const int chunks = (len + CH - 1) / CH;

    const size_t cache_off = (((size_t)bi * n_kv + kvh) * (size_t)total + p0) * D;
    const T* kb = k + cache_off;
    const T* vb = v + cache_off;
    const float* bb = bias + (size_t)bi * total + p0;

    // chunk c of K (or V) into its slot, counted on the slot's barrier
    auto issue = [&](const T* src, unsigned char* ring, uint64_t* bars, int slots, int c) {
        const int slot = c % slots;
        const uint32_t bytes = (uint32_t)min(CH, len - c * CH) * D * sizeof(T);
        hp::mbar_arrive_expect_tx(&bars[slot], bytes);
        hp::bulk_load(ring + slot * CHB, src + (size_t)c * CH * D, bytes, &bars[slot]);
    };
    if (tid == 0) {  // K's ring at once; V chunk c follows once K chunk c is read (below)
        for (int s = 0; s < kslots + vslots; ++s) hp::mbar_init(&kbar[s], 1);
        hp::mbar_init_fence();
        for (int c = 0; c < min(chunks, kslots); ++c) issue(kb, kring, kbar, kslots, c);
    }
    for (int i = tid; i < GT * D; i += NTHREADS) {
        const int g = i / D;
        qs[i] = g0 + g < group ? q[((size_t)bi * h + (size_t)kvh * group + g0 + g) * D + i % D] : from_f<T>(0.0f);
    }
    for (int i = tid; i < len; i += NTHREADS) bsm[i] = __ldg(bb + i);
    __syncthreads();  // q rows and bias staged (their loads overlap the first copies), barriers initialised

    // ---- score pass: one lane per position ----------------------------------
    float mx[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) mx[g] = -INFINITY;
    for (int c = 0; c < chunks; ++c) {
        const int slot = c % kslots;
        if (slot % NW != warp) continue;
        hp::mbar_wait(&kbar[slot], (c / kslots) & 1);
        const int i = c * CH + lane;
        if (i < len) {
            const T* krow = reinterpret_cast<const T*>(kring + slot * CHB) + lane * D;
            float acc[GT][E];  // E independent partial sums a group member: short dependency chains
#pragma unroll
            for (int g = 0; g < GT; ++g)
#pragma unroll
                for (int e = 0; e < E; ++e) acc[g][e] = 0.0f;
#pragma unroll
            for (int t = 0; t < NV; ++t) {
                const int cv = (t + lane) % NV;  // lane-rotated: neighbouring lanes on different banks
                float kv[E];
                Vec<T>::load(krow + cv * E, kv);
#pragma unroll
                for (int g = 0; g < GT; ++g) {
                    float qv[E];
                    Vec<T>::load(qs + g * D + cv * E, qv);
#pragma unroll
                    for (int e = 0; e < E; ++e) acc[g][e] = fmaf(qv[e], kv[e], acc[g][e]);
                }
            }
            const float bv = bsm[i];
#pragma unroll
            for (int g = 0; g < GT; ++g) {
#pragma unroll
                for (int w = E / 2; w > 0; w >>= 1)
#pragma unroll
                    for (int e = 0; e < w; ++e) acc[g][e] += acc[g][e + w];
                const float s = acc[g][0] + bv;
                S[g * spanp + i] = s;
                mx[g] = fmaxf(mx[g], s);
            }
        }
        __syncwarp();
        if (lane == 0) {
            if (c + kslots < chunks) issue(kb, kring, kbar, kslots, c + kslots);  // refill the slot just read
            if (c < vslots) issue(vb, vring, vbar, vslots, c);  // V trails K by one chunk: in flight through the softmax
        }
    }

    // ---- this block's max and sum of exp(s - max); pushed to every block ------
    float bmax[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
        const float m = warp_max(mx[g]);
        if (lane == 0) wmax[warp * GT + g] = m;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GT; ++g) {
        bmax[g] = wmax[g];
#pragma unroll
        for (int w = 1; w < NW; ++w) bmax[g] = fmaxf(bmax[g], wmax[w * GT + g]);
        float sum = 0.0f;
        for (int i = tid; i < len; i += NTHREADS) sum += expf(S[g * spanp + i] - bmax[g]);
        sum = warp_sum(sum);
        if (lane == 0) wsum[warp * GT + g] = sum;
    }
    __syncthreads();
    if (clustered) hp::cluster_wait();  // every block of the cluster has started
    if (tid < split) {  // (max, sum) of every group member into slot `rank` of block `tid`
#pragma unroll
        for (int g = 0; g < GT; ++g) {
            float sum = 0.0f;
#pragma unroll
            for (int w = 0; w < NW; ++w) sum += wsum[w * GT + g];
            float* slot = stats + ((int)rank * GT + g) * 2;
            if (clustered) {
                hp::st_cluster(slot, tid, bmax[g]);
                hp::st_cluster(slot + 1, tid, sum);
            } else {
                slot[0] = bmax[g];
                slot[1] = sum;
            }
        }
    }
    if (clustered)
        hp::cluster_sync();  // every block's (max, sum) is in every block
    else
        __syncthreads();
    // the row's max and denominator, the same in every block (ranks in order),
    // then p = exp(s - max) / den rounded to the cache dtype, once a position
#pragma unroll
    for (int g = 0; g < GT; ++g) {
        float m = -INFINITY;
        for (int r = 0; r < split; ++r) m = fmaxf(m, stats[(r * GT + g) * 2]);
        float sum = 0.0f;
        for (int r = 0; r < split; ++r) sum += stats[(r * GT + g) * 2 + 1] * expf(stats[(r * GT + g) * 2] - m);
        const float den = fmaxf(sum, 1e-30f);
        for (int i = tid; i < len; i += NTHREADS) S[g * spanp + i] = rnd<T>(expf(S[g * spanp + i] - m) / den);
    }
    __syncthreads();

    // ---- PV pass: p rounded to the cache dtype, fp32 accumulation -------------
    const int sub = lane / NV;  // which of the warp's RPW rows
    const int cv = lane % NV;   // which 16-byte vector of the row
    float acc[GT][E];
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] = 0.0f;
    for (int c = 0; c < chunks; ++c) {
        const int slot = c % vslots;
        if (slot % NW != warp) continue;
        hp::mbar_wait(&vbar[slot], (c / vslots) & 1);
        const int rows = min(CH, len - c * CH);
        const T* vt = reinterpret_cast<const T*>(vring + slot * CHB);
        const float* pc = S + c * CH;
        auto pv_row = [&](int r) {
            float vv[E];
            Vec<T>::load(vt + r * D + cv * E, vv);
#pragma unroll
            for (int g = 0; g < GT; ++g) {
                const float p = pc[g * spanp + r];
#pragma unroll
                for (int e = 0; e < E; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
            }
        };
        if (rows == CH) {  // a whole chunk: unrolled, its loads issued together
#pragma unroll
            for (int r = 0; r < CH; r += RPW) pv_row(r + sub);
        } else {
            for (int r = sub; r < rows; r += RPW) pv_row(r);
        }
        __syncwarp();
        if (lane == 0 && c + vslots < chunks) issue(vb, vring, vbar, vslots, c + vslots);
    }
    // the warp's row groups, then the block's warps; the block's partial o to rank 0
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e) {
            float a = acc[g][e];
#pragma unroll
            for (int off = NV; off < 32; off <<= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
            if (sub == 0) red[(warp * GT + g) * D + cv * E + e] = a;
        }
    __syncthreads();
    for (int i = tid; i < GT * D; i += NTHREADS) {
        float a = 0.0f;
#pragma unroll
        for (int w = 0; w < NW; ++w) a += red[w * GT * D + i];
        if (clustered)
            hp::st_cluster(pall + (int)rank * GT * D + i, 0, a);
        else
            pall[i] = a;
    }
    if (clustered)
        hp::cluster_sync();  // every block's partial o is in rank 0
    else
        __syncthreads();
    if (rank == 0) {
        for (int i = tid; i < GT * D; i += NTHREADS) {
            const int g = i / D;
            if (g0 + g >= group) continue;
            float a = 0.0f;
            for (int r = 0; r < split; ++r) a += pall[r * GT * D + i];
            o[((size_t)bi * h + (size_t)kvh * group + g0 + g) * D + i % D] = from_f<T>(a);
        }
    }
}

int sm_count() {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
            sms = 132;
    }
    return sms;
}

// The launch's span and rings: K's ring within K_RING; V's the whole span
// when the block's share of an SM (the grid in one wave) allows, else as much
// of it as that share holds, at most V_RING.
template <typename T, int D, int GT>
struct Plan {
    int span, kslots, vslots;
    size_t smem;
    Plan(int b, int n_kv, int group, int total, int split) {
        span = (total + split - 1) / split;
        const int chunks = (span + CH - 1) / CH;
        const int blocks = n_kv * split * b * ((group + GT - 1) / GT);
        const int per_sm = (blocks + sm_count() - 1) / sm_count();
        kslots = ring_slots<T, D>(chunks, K_RING);
        const int share = SM_SMEM / per_sm - 1024 - (int)smem_layout<T, D, GT>(span, kslots, 0, split).bytes;
        vslots = ring_slots<T, D>(chunks, share < V_RING ? share : V_RING);
        smem = smem_layout<T, D, GT>(span, kslots, vslots, split).bytes;
    }
};

template <typename T, int D, int GT>
int launch(const void* q, const void* k, const void* v, const void* bias, void* o, int b, int h, int n_kv,
           int total, int split, cudaStream_t stream) {
    const int group = h / n_kv;
    const Plan<T, D, GT> plan(b, n_kv, group, total, split);
    if ((split - 1) * plan.span >= total || plan.smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
    if (plan.smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(decode_attn<T, D, GT>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.smem);
        if (err != cudaSuccess) return (int)err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_kv * split, b, (group + GT - 1) / GT);
    cfg.blockDim = dim3(NTHREADS);
    cfg.dynamicSmemBytes = plan.smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, decode_attn<T, D, GT>, static_cast<const T*>(q),
                                               static_cast<const T*>(k), static_cast<const T*>(v),
                                               static_cast<const float*>(bias), static_cast<T*>(o), h, n_kv, total,
                                               split, plan.span, plan.kslots, plan.vslots);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// f(T*, integral_constant<D>, integral_constant<GT>) for a runtime dtype,
// head dim and group size; -1 for a head dim the kernel is not built for.
template <typename F>
long long dispatch(int is_bf16, int d, int group, F f) {
    auto with_gt = [&](auto* t, auto dc) -> long long {
        switch (group_tile(group)) {
            case 1: return f(t, dc, std::integral_constant<int, 1>{});
            case 2: return f(t, dc, std::integral_constant<int, 2>{});
            default: return f(t, dc, std::integral_constant<int, 4>{});  // larger groups: tiles of 4
        }
    };
    auto with_d = [&](auto* t) -> long long {
        switch (d) {
            case 32: return with_gt(t, std::integral_constant<int, 32>{});
            case 64: return with_gt(t, std::integral_constant<int, 64>{});
            case 128: return with_gt(t, std::integral_constant<int, 128>{});
            default: return -1;
        }
    };
    return is_bf16 ? with_d(static_cast<bf16*>(nullptr)) : with_d(static_cast<float*>(nullptr));
}

bool valid(int b, int h, int n_kv, int total, int split) {
    return b >= 1 && b <= 65535 && n_kv >= 1 && h % n_kv == 0 && total >= 1 && split >= 1 && split <= MAX_CLUSTER;
}

}  // namespace

extern "C" {

// q, o: (b, h, 1, d) contiguous; k, v: (b, n_kv, total, d) contiguous; all
// bf16 (is_bf16 = 1) or fp32; bias: (b, total) fp32; split: blocks per
// cluster (1..8), each owning ceil(total / split) positions, none empty.
// Returns the cudaError_t of the launch.
int f5_decode_attention(const void* q, const void* k, const void* v, const void* bias, void* o, int b, int h,
                        int n_kv, int total, int d, int is_bf16, int split, void* stream) {
    if (!valid(b, h, n_kv, total, split)) return (int)cudaErrorInvalidValue;
    const long long err = dispatch(is_bf16, d, h / n_kv, [&](auto* t, auto dc, auto gtc) -> long long {
        using T = std::remove_pointer_t<decltype(t)>;
        return launch<T, decltype(dc)::value, decltype(gtc)::value>(q, k, v, bias, o, b, h, n_kv, total, split,
                                                                    static_cast<cudaStream_t>(stream));
    });
    return err < 0 ? (int)cudaErrorInvalidValue : (int)err;
}

// Bytes of dynamic shared memory the launch above asks for (-1: arguments it
// refuses), and the most a block may have.
long long f5_decode_attention_smem(int b, int h, int n_kv, int total, int d, int is_bf16, int split) {
    if (!valid(b, h, n_kv, total, split)) return -1;
    return dispatch(is_bf16, d, h / n_kv, [&](auto* t, auto dc, auto gtc) -> long long {
        using T = std::remove_pointer_t<decltype(t)>;
        return (long long)Plan<T, decltype(dc)::value, decltype(gtc)::value>(b, n_kv, h / n_kv, total, split).smem;
    });
}
int f5_decode_attention_max_smem() { return MAX_SMEM; }

const char* f5_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
