// Kernels K and L: the xor-hash corner encode and its backward.
//
// K replaces the forward that XLA fused on the TPU for two encodings that
// read the hash table by corner, with an xor hash:
//   * GridEncoding with layout "plain" (tcnn's indexing),
//     nerfshop_tpu/models/encodings.py:155-195 (_corner_indices) and :380-383;
//   * TakikawaEncoding.apply, nerfshop_tpu/models/encodings.py:492-527.
// L replaces JAX's autodiff of the same functions: the table gradient (a
// scatter-add of w_c * dout into every corner's slot) and, on request, the
// position gradient. Neither had a Pallas kernel. The plain PyTorch
// versions beside them are in nerfshop_tpu_torch/ops/xor_encode.py.
//
// Per level l with scale s, resolution res, size m and offset o:
//   plain:    p = x * s + 0.5 (__fmul_rn / __fadd_rn: no FMA may move a
//             sample across a cell, as in grid_encode.cu), p0 = floor(p),
//             frac = p - p0 (not folded), corner = clamp(p0 + off, 0, res - 1),
//             slot = x + res * (y + res * z) on dense levels and
//             (x ^ y * 2654435761 ^ z * 805459861) mod m on hashed ones;
//   takikawa: res = 2^depth, p = clip(x, 0, 1) * res (exact), p0 = clamp(
//             floor(p), 0, res - 1), frac = p - p0, corner = min(p0 + off,
//             res), every level xor-hashed mod m (m is not a power of two at
//             depths 4-6, so the modulo is a real uint32 %), and the level's
//             features are zero where the octree mask at that depth is empty.
// The hash is uint32 arithmetic with wrap-around. Weights are
// w_c = prod_d (c_d ? frac_d : 1 - frac_d); out_l = sum_c w_c * table[o + slot_c].
// Takikawa with sum_instead_of_concat adds the levels in order into [N, F].
//
// L: d table[o + slot_c] += w_c * dout_l (zero where the mask is empty) by
// vectorised atomicAdd (float4 on sm_90), so the order of the sums changes
// from run to run; d x_d = sum_l sum_c <dout_l, row_c> * dw_c/dfrac_d
// * ds_d, with ds_d = s on plain levels and, on Takikawa's, res times
// JAX's derivative of clip: 1 inside (0, 1), 1/2 at exactly 0 or 1 (lax.max
// and lax.min split a tie), 0 outside. L recomputes the slots and weights
// from x rather than reading stored [N, L, 2^D] indices.
//
// What bounds them on the H100: each (sample, level) reads 2^D corner rows
// of F floats at unrelated slots (8-32 B each, one 32-byte sector or less)
// and writes F floats. The first versions (a thread a (sample, level) in K,
// each warp's lanes on 16 levels) were bound by the work of each thread, not
// by sector reads: K took 2.06 ms at 2^20 positions whatever their repeats,
// 0.52 ms at 2^18 uniform ones (profile_render.py --xor). The second:
//   * K on the plain layout and L take a thread a sample over the levels in
//     order, so that a warp reads one level record at a time (a broadcast
//     from the launch's parameters), takes one branch of the dense / hashed
//     / power-of-two tests, reads x once and divides nothing in 64 bits;
//     K stages its output rows in shared memory (a pitch against bank
//     conflicts) and stores whole lines;
//   * K on Takikawa's levels keeps a thread a (sample, level): a block takes
//     32 samples and warp l their level l, its rows staged the same way (a
//     loop over levels serialises each level's mask load before its rows
//     and measured slower; a level a block row wrote 32-byte pieces of
//     rows 320 bytes apart, 3x slower on a frame's 2^21 positions);
//   * the y and z part of a corner's index is hashed once for its two
//     x-neighbours, and at F = 2 the pair is read in one 16-byte load where
//     its rows are the halves of an aligned 16-byte span (a power-of-two
//     hashed level at even p0.x: the x + 1 slot is the x slot xor 1; a
//     dense level at an even row), never where the corner is clamped;
//   * dense levels skip the modulo (their index is below res^D <= m);
//   * L adds a corner pair's two rows by one float4 atomic where they share
//     a span, and, at a level where two lanes of the warp share a cell,
//     sums the lanes that add to the same rows first (__match_any_sync,
//     then a segmented tree of shuffles over each run of neighbouring
//     lanes: repeated positions, samples along a ray), one atomic a run.
// Both staged kernels carry a register budget in their launch bounds:
// without it ptxas took 32 registers and spilled, and the plain kernel ran
// at 0.35 ms instead of 0.23 at 2^18 samples. On an H100
// (profile_render.py --xor, device time) K takes 0.23 ms at 2^18 uniform
// samples of the default plain grid and 0.19 ms at 2^20 positions repeated
// 16 times (v1: 0.52, 2.04); L 0.74 and 0.68 (v1: 0.83, 2.45). L's table
// half and K at random samples stay bound by scattered 32-byte sectors of
// a table about the L2's size.
// K sums the 2^D corners in the first version's order with the same w * r
// products, so its output is bit-equal to it; L's position gradient sums in
// registers, the same on every call.
//
// Shapes: x [N, D] f32; table [sum m, F] f32; mask [sum of mask cells] u8
// (Takikawa only); out [N, L*F] or [N, F] f32; dout like out; dtable like
// table (zeroed by the caller); dx [N, D] f32. D = 3 or 2 (plain), D = 3
// (Takikawa); F = 2 (plain), 2, 4 or 8 (Takikawa); at most 32 levels.

#include <cuda_runtime.h>
#include <stdint.h>

#if defined(__CUDACC_VER_MAJOR__) && (__CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
#define NST_VECTOR_ATOMICS 1
#else
#define NST_VECTOR_ATOMICS 0
#endif

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;          // L
constexpr int kThreadsK = 128;         // K
// K's staged kernel's blocks an SM: a register budget of 64 (without it
// ptxas trades a few spilled bytes for a 32-register occupancy step)
constexpr int kBlocksK = 8;
constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;
constexpr uint32_t kNoKey = 0xffffffffu;  // a lane that adds nothing
constexpr unsigned kFull = 0xffffffffu;

}  // namespace

// one level, field for field XorLevel of nerfshop_tpu_torch/kernels.py
struct XorLevel {
    float scale;   // plain: the level's scale; takikawa: 2^depth
    int res;       // plain: the level's resolution; takikawa: 2^depth
    uint32_t m;    // slots in the level
    int offset;    // the level's first row in the table
    int dense;     // plain: dense indexing
    int mask_off;  // takikawa: the first cell of the level's mask
    int mask_res;  // takikawa: the mask's side
    int pow2;      // m is a power of two: mod by a mask
};

struct XorArgs {
    XorLevel lv[kMaxLevels];
    int n_levels, D, F, takikawa, sum;
};

namespace {

template <int D, bool TAKI>
struct Cell {
    int p0[D];
    float frac[D];
    float ds[D];  // d frac / d x
    bool inside;
};

template <int D, bool TAKI>
__device__ __forceinline__ Cell<D, TAKI> cell_of(const XorLevel& lv, const float (&x)[D], const uint8_t* __restrict__ mask) {
    Cell<D, TAKI> c;
    c.inside = true;
#pragma unroll
    for (int d = 0; d < D; ++d) {
        if constexpr (TAKI) {
            const float xc = fminf(fmaxf(x[d], 0.f), 1.f);
            const float p = __fmul_rn(xc, lv.scale);
            int p0 = (int)floorf(p);
            p0 = p0 < 0 ? 0 : (p0 > lv.res - 1 ? lv.res - 1 : p0);
            c.p0[d] = p0;
            c.frac[d] = p - (float)p0;
            c.ds[d] = x[d] > 0.f && x[d] < 1.f ? lv.scale : (x[d] == 0.f || x[d] == 1.f ? 0.5f * lv.scale : 0.f);
        } else {
            const float p = __fadd_rn(__fmul_rn(x[d], lv.scale), 0.5f);
            const float p0f = floorf(p);
            c.p0[d] = (int)p0f;
            c.frac[d] = p - p0f;
            c.ds[d] = lv.scale;
        }
    }
    if constexpr (TAKI) {
        const int mr = lv.mask_res;
        int mc[D];
#pragma unroll
        for (int d = 0; d < D; ++d) {
            int v = (c.p0[d] * mr) / lv.res;
            mc[d] = v < 0 ? 0 : (v > mr - 1 ? mr - 1 : v);
        }
        c.inside = __ldg(mask + lv.mask_off + (mc[0] * mr + mc[1]) * mr + mc[D - 1]) != 0;
    }
    return c;
}

// The global table rows of a level's 2^D corners as 2^(D-1) x-neighbour
// pairs: r0[j] is corner 2j (x low), r1[j] corner 2j + 1 (x high); bit d of
// a corner's number is its offset on axis d. The y and z part of the index
// is computed once a pair.
template <int D, bool TAKI>
__device__ __forceinline__ void corner_rows(const XorLevel& lv, const Cell<D, TAKI>& c, uint32_t (&r0)[1 << (D - 1)],
                                            uint32_t (&r1)[1 << (D - 1)]) {
    const int res = lv.res;
    int x0 = c.p0[0], x1 = c.p0[0] + 1;
    if constexpr (TAKI) {
        x1 = x1 > res ? res : x1;  // p0 is within [0, res - 1]
    } else {
        x0 = x0 < 0 ? 0 : (x0 > res - 1 ? res - 1 : x0);
        x1 = x1 < 0 ? 0 : (x1 > res - 1 ? res - 1 : x1);
    }
#pragma unroll
    for (int j = 0; j < (1 << (D - 1)); ++j) {
        uint32_t u[D];
#pragma unroll
        for (int d = 1; d < D; ++d) {
            int v = c.p0[d] + ((j >> (d - 1)) & 1);
            if constexpr (TAKI) {
                v = v > res ? res : v;
            } else {
                v = v < 0 ? 0 : (v > res - 1 ? res - 1 : v);
            }
            u[d] = (uint32_t)v;
        }
        uint32_t h0, h1;
        if (!TAKI && lv.dense) {
            // below res^D <= m: JAX's modulo is the identity here
            const uint32_t r = (uint32_t)res;
            const uint32_t yz = D == 3 ? r * (u[1] + r * u[D - 1]) : r * u[1];
            h0 = (uint32_t)x0 + yz;
            h1 = (uint32_t)x1 + yz;
        } else {
            uint32_t yz = u[1] * kPrime1;
            if (D == 3) yz ^= u[D - 1] * kPrime2;
            h0 = (uint32_t)x0 ^ yz;
            h1 = (uint32_t)x1 ^ yz;
            if (lv.pow2) {
                h0 &= lv.m - 1u;
                h1 &= lv.m - 1u;
            } else {
                h0 %= lv.m;
                h1 %= lv.m;
            }
        }
        r0[j] = (uint32_t)lv.offset + h0;
        r1[j] = (uint32_t)lv.offset + h1;
    }
}

// corner k's weight, and its derivative along each axis
template <int D, bool TAKI>
__device__ __forceinline__ float weight_of(const Cell<D, TAKI>& c, int k, float (&dw)[D]) {
    float f[D];
#pragma unroll
    for (int d = 0; d < D; ++d) f[d] = (k >> d) & 1 ? c.frac[d] : 1.f - c.frac[d];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        float g = (k >> d) & 1 ? 1.f : -1.f;
#pragma unroll
        for (int e = 0; e < D; ++e) {
            if (e != d) g *= f[e];
        }
        dw[d] = g;
    }
    float w = f[0];
#pragma unroll
    for (int d = 1; d < D; ++d) w *= f[d];
    return w;
}

template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float (&r)[F]) {
    if constexpr (F == 2) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(p));
        r[0] = v.x;
        r[1] = v.y;
    } else {
#pragma unroll
        for (int h = 0; h < F / 4; ++h) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(p) + h);
            r[4 * h] = v.x;
            r[4 * h + 1] = v.y;
            r[4 * h + 2] = v.z;
            r[4 * h + 3] = v.w;
        }
    }
}

// the rows of an x-neighbour pair: one 16-byte load where they are the two
// rows of an aligned 16-byte span, in either order (F = 2), else a load a row
template <int F>
__device__ __forceinline__ void load_pair(const float* __restrict__ table, uint32_t r0, uint32_t r1, float (&a)[F],
                                          float (&b)[F]) {
    if constexpr (F == 2) {
        if ((r0 ^ r1) == 1u) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(table + (size_t)(r0 & ~1u) * 2));
            const bool odd = r0 & 1u;
            a[0] = odd ? v.z : v.x;
            a[1] = odd ? v.w : v.y;
            b[0] = odd ? v.x : v.z;
            b[1] = odd ? v.y : v.w;
            return;
        }
    }
    load_row<F>(table + (size_t)r0 * F, a);
    load_row<F>(table + (size_t)r1 * F, b);
}

template <int F>
__device__ __forceinline__ void store_row(float* p, const float (&r)[F]) {
    if constexpr (F == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
    } else {
#pragma unroll
        for (int h = 0; h < F / 4; ++h) {
            reinterpret_cast<float4*>(p)[h] = make_float4(r[4 * h], r[4 * h + 1], r[4 * h + 2], r[4 * h + 3]);
        }
    }
}

// W floats (a multiple of 4) added to p by float4 atomics
template <int W>
__device__ __forceinline__ void add_vec(float* p, const float (&r)[W]) {
#if NST_VECTOR_ATOMICS
#pragma unroll
    for (int h = 0; h < W / 4; ++h) {
        atomicAdd(reinterpret_cast<float4*>(p) + h, make_float4(r[4 * h], r[4 * h + 1], r[4 * h + 2], r[4 * h + 3]));
    }
#else
#pragma unroll
    for (int f = 0; f < W; ++f) atomicAdd(p + f, r[f]);
#endif
}

// Adds v to dtable[key * W .. + W] (nothing where key is kNoKey). Where the
// caller found lanes of the warp on one cell (`gather`), the lanes with the
// same key that form a run of neighbouring lanes (repeated positions,
// samples along a ray) are summed by a segmented tree of shuffles and the
// run's first lane adds; a lane whose key repeats elsewhere adds alone.
// Every lane of the warp calls it.
template <int W>
__device__ __forceinline__ void scatter(float* __restrict__ dtable, uint32_t key, float (&v)[W], int lane, bool gather) {
    if (gather) {
        const unsigned m = __match_any_sync(kFull, key);
        const int first = __ffs(m) - 1;
        const unsigned run = m >> first;
        const bool in_run = key != kNoKey && (run & (run + 1u)) == 0u;
        const int size = in_run ? __popc(m) : 1;
        const int last = in_run ? first + size - 1 : lane;
        const int big = (int)__reduce_max_sync(kFull, (unsigned)size);
        for (int s = 1; s < big; s <<= 1) {
#pragma unroll
            for (int f = 0; f < W; ++f) {
                const float o = __shfl_down_sync(kFull, v[f], s);
                if (lane + s <= last) v[f] += o;
            }
        }
        if (key != kNoKey && (!in_run || lane == first)) add_vec<W>(dtable + (size_t)key * W, v);
        return;
    }
    if (key != kNoKey) add_vec<W>(dtable + (size_t)key * W, v);
}

template <int D>
__device__ __forceinline__ void load_x(const float* __restrict__ x, long long n, float (&v)[D]) {
#pragma unroll
    for (int d = 0; d < D; ++d) v[d] = __ldg(x + n * D + d);
}

// one level's features of one sample (zero where Takikawa's mask is empty):
// the corners summed in order k = 0 .. 2^D - 1, w_k * row_k each; at F = 2
// the rows are read by x-neighbour pairs, above it one load a corner
template <int D, int F, bool TAKI>
__device__ __forceinline__ void encode_level(const XorLevel& lv, const float (&xv)[D], const float* __restrict__ table,
                                             const uint8_t* __restrict__ mask, float (&acc)[F]) {
    constexpr int P = 1 << (D - 1);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;
    const Cell<D, TAKI> c = cell_of<D, TAKI>(lv, xv, mask);
    if (!c.inside) return;
    uint32_t r0[P], r1[P];
    corner_rows<D, TAKI>(lv, c, r0, r1);
    if constexpr (F == 2) {
        float a[P][F], b[P][F];
#pragma unroll
        for (int j = 0; j < P; ++j) load_pair<F>(table, r0[j], r1[j], a[j], b[j]);
#pragma unroll
        for (int j = 0; j < P; ++j) {
            float dw[D];
            float w = weight_of<D, TAKI>(c, 2 * j, dw);
#pragma unroll
            for (int f = 0; f < F; ++f) acc[f] += w * a[j][f];
            w = weight_of<D, TAKI>(c, 2 * j + 1, dw);
#pragma unroll
            for (int f = 0; f < F; ++f) acc[f] += w * b[j][f];
        }
    } else {
#pragma unroll
        for (int k = 0; k < (1 << D); ++k) {
            float dw[D];
            const float w = weight_of<D, TAKI>(c, k, dw);
            float r[F];
            load_row<F>(table + (size_t)(k & 1 ? r1[k >> 1] : r0[k >> 1]) * F, r);
#pragma unroll
            for (int f = 0; f < F; ++f) acc[f] += w * r[f];
        }
    }
}

// K's staged row pitch in floats for rows of L levels of F features: a
// multiple of the store's vector width whose quotient by it is odd, so that
// the lanes of a store phase (16 of float2, 8 of float4) hit distinct banks
template <int F>
__host__ __device__ __forceinline__ int stage_pitch(int n_levels) {
    return F == 8 ? 8 * n_levels + 4 : F * (n_levels | 1);
}

// Stores a block's staged output rows (rows of L * F floats at the pitch
// above) to out[base ..] as whole lines: each warp stores 32 / L rows at
// once where a row is under 32 vectors, else one row a pass
template <int F>
__device__ __forceinline__ void store_staged(const float* stage, int L, float* __restrict__ out, long long base,
                                             int rows) {
    constexpr int V = F == 2 ? 2 : 4;  // floats a store
    const int vecs = L * F / V, pitch = stage_pitch<F>(L);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    const int per = vecs < 32 ? 32 / vecs : 1;
    const int sub = vecs < 32 ? lane / vecs : 0;
    const int col = vecs < 32 ? lane - sub * vecs : lane;
    if (sub >= per) return;
    for (int r = warp * per + sub; r < rows; r += warps * per) {
        const float* src = stage + r * pitch;
        float* dst = out + (base + r) * L * F;
        for (int c = col; c < vecs; c += 32) {
            if constexpr (V == 2) {
                reinterpret_cast<float2*>(dst)[c] = reinterpret_cast<const float2*>(src)[c];
            } else {
                reinterpret_cast<float4*>(dst)[c] = reinterpret_cast<const float4*>(src)[c];
            }
        }
    }
}

// K, the plain layout (F = 2): a thread a sample over the levels in order,
// its output row staged in shared memory, then stored as whole lines
template <int D>
__global__ void __launch_bounds__(kThreadsK, kBlocksK)
xor_encode_kernel(const __grid_constant__ XorArgs a, const float* __restrict__ x, const float* __restrict__ table,
                  float* __restrict__ out, long long n) {
    extern __shared__ float4 stage_raw[];
    float* stage = reinterpret_cast<float*>(stage_raw);
    const int L = a.n_levels;
    const long long base = (long long)blockIdx.x * blockDim.x;
    const long long s = base + threadIdx.x;
    if (s < n) {
        float xv[D];
        load_x<D>(x, s, xv);
        float* mine = stage + threadIdx.x * stage_pitch<2>(L);
        for (int l = 0; l < L; ++l) {
            float acc[2];
            encode_level<D, 2, false>(a.lv[l], xv, table, nullptr, acc);
            store_row<2>(mine + l * 2, acc);
        }
    }
    __syncthreads();
    store_staged<2>(stage, L, out, base, (int)(n - base < (long long)blockDim.x ? n - base : (long long)blockDim.x));
}

// K, Takikawa's levels concatenated: a block takes 32 samples, warp l their
// level l (the level record and the mask's branch are the warp's, and each
// level's mask load before its rows runs in a warp of its own rather than
// in a chain over the levels), the rows staged in shared memory, then
// stored as whole lines
template <int F>
__global__ void __launch_bounds__(32 * kMaxLevels, 1)
xor_encode_levels_kernel(const __grid_constant__ XorArgs a, const float* __restrict__ x, const float* __restrict__ table,
                         const uint8_t* __restrict__ mask, float* __restrict__ out, long long n) {
    extern __shared__ float4 stage_raw[];
    float* stage = reinterpret_cast<float*>(stage_raw);
    const int L = a.n_levels, l = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long base = (long long)blockIdx.x * 32;
    const long long s = base + lane;
    if (s < n) {
        float xv[3];
        load_x<3>(x, s, xv);
        float acc[F];
        encode_level<3, F, true>(a.lv[l], xv, table, mask, acc);
        store_row<F>(stage + lane * stage_pitch<F>(L) + l * F, acc);
    }
    __syncthreads();
    store_staged<F>(stage, L, out, base, (int)(n - base < 32 ? n - base : 32));
}

// K, levels summed (Takikawa's sum_instead_of_concat): a thread a sample,
// the levels added in order
template <int D, int F>
__global__ void __launch_bounds__(kThreadsK)
xor_encode_sum_kernel(const __grid_constant__ XorArgs a, const float* __restrict__ x, const float* __restrict__ table,
                      const uint8_t* __restrict__ mask, float* __restrict__ out, long long n) {
    for (long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x; s < n; s += (long long)gridDim.x * blockDim.x) {
        float xv[D];
        load_x<D>(x, s, xv);
        float tot[F];
#pragma unroll
        for (int f = 0; f < F; ++f) tot[f] = 0.f;
        for (int l = 0; l < a.n_levels; ++l) {
            float acc[F];
            encode_level<D, F, true>(a.lv[l], xv, table, mask, acc);
#pragma unroll
            for (int f = 0; f < F; ++f) tot[f] += acc[f];
        }
        store_row<F>(out + s * F, tot);
    }
}

// L: a thread a sample over its levels; dtable (zeroed) by atomics through
// scatter (F = 2: a float4 at the row pair of each corner pair, both x
// corners in one where they share it), dx summed in registers in the first
// version's order. Either output may be null. Every lane of a warp runs
// every level (scatter's warp-wide calls): a lane past n or outside
// Takikawa's mask adds nothing.
template <int D, int F, bool TAKI>
__global__ void __launch_bounds__(kThreads)
xor_encode_bwd_kernel(const __grid_constant__ XorArgs a, const float* __restrict__ x, const float* __restrict__ table,
                      const uint8_t* __restrict__ mask, const float* __restrict__ dout, float* __restrict__ dtable,
                      float* __restrict__ dx, long long n) {
    constexpr int P = 1 << (D - 1);
    const int L = a.n_levels;
    const int width = a.sum ? F : L * F;
    const int lane = threadIdx.x & 31;
    for (long long base = blockIdx.x * (long long)blockDim.x; base < n; base += (long long)gridDim.x * blockDim.x) {
        const long long s = base + threadIdx.x;
        const bool valid = s < n;
        float xv[D];
        load_x<D>(x, valid ? s : 0, xv);
        float gx[D];
#pragma unroll
        for (int d = 0; d < D; ++d) gx[d] = 0.f;
        for (int l = 0; l < L; ++l) {
            const XorLevel& lv = a.lv[l];
            const Cell<D, TAKI> c = cell_of<D, TAKI>(lv, xv, mask);
            const bool live = valid && c.inside;
            float g[F];
#pragma unroll
            for (int f = 0; f < F; ++f) g[f] = 0.f;
            if (live) load_row<F>(dout + s * width + (a.sum ? 0 : l * F), g);
            uint32_t r0[P], r1[P];
            corner_rows<D, TAKI>(lv, c, r0, r1);
            if (dtable) {
                // do two live lanes share this level's cell? (a hash of it:
                // a collision only costs the gathering)
                uint32_t cell = (uint32_t)c.p0[0] ^ (uint32_t)c.p0[1] * kPrime1;
                if (D == 3) cell ^= (uint32_t)c.p0[D - 1] * kPrime2;
                const unsigned shared_cell = __match_any_sync(kFull, live ? cell : kNoKey);
                const bool gather = __any_sync(kFull, live && __popc(shared_cell) > 1);
#pragma unroll
                for (int j = 0; j < P; ++j) {
                    float dw[D];
                    const float w0 = weight_of<D, TAKI>(c, 2 * j, dw);
                    const float w1 = weight_of<D, TAKI>(c, 2 * j + 1, dw);
                    if constexpr (F == 2) {
                        // both corners' w * g at the 16-byte row pair of r0, r1's
                        // too where it shares it; else r1's in a second round
                        const uint32_t q0 = r0[j] >> 1, q1 = r1[j] >> 1;
                        const bool h0 = r0[j] & 1u, h1 = r1[j] & 1u, shared = q1 == q0;
                        float va[4];
                        va[0] = h0 ? 0.f : w0 * g[0];
                        va[1] = h0 ? 0.f : w0 * g[1];
                        va[2] = h0 ? w0 * g[0] : 0.f;
                        va[3] = h0 ? w0 * g[1] : 0.f;
                        if (shared && h1) {
                            va[2] += w1 * g[0];
                            va[3] += w1 * g[1];
                        } else if (shared) {
                            va[0] += w1 * g[0];
                            va[1] += w1 * g[1];
                        }
                        scatter<4>(dtable, live ? q0 : kNoKey, va, lane, gather);
                        const bool split = live && !shared;
                        if (__any_sync(kFull, split)) {
                            float vb[4];
                            vb[0] = h1 ? 0.f : w1 * g[0];
                            vb[1] = h1 ? 0.f : w1 * g[1];
                            vb[2] = h1 ? w1 * g[0] : 0.f;
                            vb[3] = h1 ? w1 * g[1] : 0.f;
                            scatter<4>(dtable, split ? q1 : kNoKey, vb, lane, gather);
                        }
                    } else {
                        float v[F];
#pragma unroll
                        for (int f = 0; f < F; ++f) v[f] = w0 * g[f];
                        scatter<F>(dtable, live ? r0[j] : kNoKey, v, lane, gather);
#pragma unroll
                        for (int f = 0; f < F; ++f) v[f] = w1 * g[f];
                        scatter<F>(dtable, live ? r1[j] : kNoKey, v, lane, gather);
                    }
                }
            }
            if (dx && live) {
                float ra[P][F], rb[P][F];
#pragma unroll
                for (int j = 0; j < P; ++j) load_pair<F>(table, r0[j], r1[j], ra[j], rb[j]);
#pragma unroll
                for (int k = 0; k < (1 << D); ++k) {
                    float dw[D];
                    weight_of<D, TAKI>(c, k, dw);
                    const float* r = k & 1 ? rb[k >> 1] : ra[k >> 1];
                    float dot = 0.f;
#pragma unroll
                    for (int f = 0; f < F; ++f) dot += g[f] * r[f];
#pragma unroll
                    for (int d = 0; d < D; ++d) gx[d] += dot * dw[d] * c.ds[d];
                }
            }
        }
        if (dx && valid) {
#pragma unroll
            for (int d = 0; d < D; ++d) dx[s * D + d] = gx[d];
        }
    }
}

int blocks_for(long long work, int threads) {
    long long b = (work + threads - 1) / threads;
    return (int)(b < 1 ? 1 : (b > (1LL << 30) ? (1LL << 30) : b));
}

template <int D, int F, bool TAKI>
int launch_fwd(const XorArgs& a, const float* x, const float* table, const uint8_t* mask, float* out, long long n,
               cudaStream_t stream) {
    if constexpr (TAKI) {
        if (a.sum) {
            xor_encode_sum_kernel<D, F><<<blocks_for(n, kThreadsK), kThreadsK, 0, stream>>>(a, x, table, mask, out, n);
        } else {
            const int stage = 32 * stage_pitch<F>(a.n_levels) * (int)sizeof(float);  // at most 33,280 B
            xor_encode_levels_kernel<F><<<blocks_for(n, 32), 32 * a.n_levels, stage, stream>>>(a, x, table, mask, out, n);
        }
    } else {
        const int stage = kThreadsK * stage_pitch<2>(a.n_levels) * (int)sizeof(float);  // at most 33,792 B
        xor_encode_kernel<D><<<blocks_for(n, kThreadsK), kThreadsK, stage, stream>>>(a, x, table, out, n);
    }
    return (int)cudaGetLastError();
}

template <int D, int F, bool TAKI>
int launch_bwd(const XorArgs& a, const float* x, const float* table, const uint8_t* mask, const float* dout,
               float* dtable, float* dx, long long n, cudaStream_t stream) {
    xor_encode_bwd_kernel<D, F, TAKI><<<blocks_for(n, kThreads), kThreads, 0, stream>>>(a, x, table, mask, dout, dtable,
                                                                                      dx, n);
    return (int)cudaGetLastError();
}

bool args_ok(const XorArgs* a, int n) {
    if (!a || n < 0 || a->n_levels < 1 || a->n_levels > kMaxLevels) return false;
    if (a->takikawa) return a->D == 3 && (a->F == 2 || a->F == 4 || a->F == 8);
    return (a->D == 3 || a->D == 2) && a->F == 2 && !a->sum;
}

}  // namespace

// Kernel K: out [n, L*F] (or [n, F] with a->sum) from x [n, D], the table
// and (Takikawa) the mask. A configuration outside args_ok returns
// cudaErrorInvalidValue without launching.
extern "C" int nst_xor_encode(const XorArgs* a, const void* x, const void* table, const void* mask, void* out, int n,
                              void* stream) {
    if (!args_ok(a, n)) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const float* px = (const float*)x;
    const float* pt = (const float*)table;
    const uint8_t* pm = (const uint8_t*)mask;
    float* po = (float*)out;
    cudaStream_t s = (cudaStream_t)stream;
    if (!a->takikawa) {
        return a->D == 3 ? launch_fwd<3, 2, false>(*a, px, pt, pm, po, n, s) : launch_fwd<2, 2, false>(*a, px, pt, pm, po, n, s);
    }
    switch (a->F) {
        case 2: return launch_fwd<3, 2, true>(*a, px, pt, pm, po, n, s);
        case 4: return launch_fwd<3, 4, true>(*a, px, pt, pm, po, n, s);
        default: return launch_fwd<3, 8, true>(*a, px, pt, pm, po, n, s);
    }
}

// Kernel L: dtable [sum m, F] (zeroed by the caller; null: not computed)
// and dx [n, D] (null: not computed) from x, the table, the mask and dout.
extern "C" int nst_xor_encode_bwd(const XorArgs* a, const void* x, const void* table, const void* mask, const void* dout,
                                  void* dtable, void* dx, int n, void* stream) {
    if (!args_ok(a, n)) return (int)cudaErrorInvalidValue;
    if (n == 0 || (!dtable && !dx)) return (int)cudaGetLastError();
    const float* px = (const float*)x;
    const float* pt = (const float*)table;
    const uint8_t* pm = (const uint8_t*)mask;
    const float* pg = (const float*)dout;
    float* pdt = (float*)dtable;
    float* pdx = (float*)dx;
    cudaStream_t s = (cudaStream_t)stream;
    if (!a->takikawa) {
        return a->D == 3 ? launch_bwd<3, 2, false>(*a, px, pt, pm, pg, pdt, pdx, n, s)
                         : launch_bwd<2, 2, false>(*a, px, pt, pm, pg, pdt, pdx, n, s);
    }
    switch (a->F) {
        case 2: return launch_bwd<3, 2, true>(*a, px, pt, pm, pg, pdt, pdx, n, s);
        case 4: return launch_bwd<3, 4, true>(*a, px, pt, pm, pg, pdt, pdx, n, s);
        default: return launch_bwd<3, 8, true>(*a, px, pt, pm, pg, pdt, pdx, n, s);
    }
}

// 1 when L's table scatter was built with float4 atomics
extern "C" int nst_xor_vector_atomics() { return NST_VECTOR_ATOMICS; }
