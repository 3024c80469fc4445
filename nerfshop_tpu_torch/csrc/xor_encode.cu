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
// vectorised atomicAdd (float2 / float4 on sm_90), so the order of the sums
// changes from run to run; d x_d = sum_l sum_c <dout_l, row_c> * dw_c/dfrac_d
// * ds_d, with ds_d = s on plain levels and, on Takikawa's, res times
// JAX's derivative of clip: 1 inside (0, 1), 1/2 at exactly 0 or 1 (lax.max
// and lax.min split a tie), 0 outside. L recomputes the slots and weights
// from x rather than reading stored [N, L, 2^D] indices.
//
// What bounds them on the H100: each (sample, level) reads 2^D corner rows
// of F floats at unrelated slots (8-32 B each, one 32-byte sector or less)
// and writes F floats; about 30 integer and float operations a corner.
// Random sector reads bound both: K at 2^18 samples x 16 levels reads
// 32 M sectors, which the L2 serves for the coarse levels and HBM for the
// fine ones. The simple design takes a thread per (sample, level) in K
// (neighbouring threads write neighbouring output rows) and a thread per
// sample in L (its position gradient sums over levels in registers).
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
constexpr int kThreads = 256;
constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;

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

// the global table row of corner k (bit d of k is the corner's offset on axis d)
template <int D, bool TAKI>
__device__ __forceinline__ uint32_t slot_of(const XorLevel& lv, const Cell<D, TAKI>& c, int k) {
    uint32_t u[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
        int v = c.p0[d] + ((k >> d) & 1);
        if constexpr (TAKI) {
            v = v > lv.res ? lv.res : v;
        } else {
            v = v < 0 ? 0 : (v > lv.res - 1 ? lv.res - 1 : v);
        }
        u[d] = (uint32_t)v;
    }
    // every level takes the mod m, dense ones too, as in JAX (their index is
    // already < res^D <= m): on the H100 a branch around it for the dense
    // levels made K slower than the modulo does (profile_render.py --xor)
    uint32_t h;
    if (!TAKI && lv.dense) {
        const uint32_t r = (uint32_t)lv.res;
        h = D == 3 ? u[0] + r * (u[1] + r * u[D - 1]) : u[0] + r * u[1];
    } else {
        h = u[0] ^ (u[1] * kPrime1);
        if (D == 3) h ^= u[D - 1] * kPrime2;
    }
    h = lv.pow2 ? (h & (lv.m - 1u)) : (h % lv.m);
    return (uint32_t)lv.offset + h;
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

template <int F>
__device__ __forceinline__ void add_row(float* p, const float (&r)[F]) {
#if NST_VECTOR_ATOMICS
    if constexpr (F == 2) {
        atomicAdd(reinterpret_cast<float2*>(p), make_float2(r[0], r[1]));
    } else {
#pragma unroll
        for (int h = 0; h < F / 4; ++h) {
            atomicAdd(reinterpret_cast<float4*>(p) + h, make_float4(r[4 * h], r[4 * h + 1], r[4 * h + 2], r[4 * h + 3]));
        }
    }
#else
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(p + f, r[f]);
#endif
}

template <int D>
__device__ __forceinline__ void load_x(const float* __restrict__ x, long long n, float (&v)[D]) {
#pragma unroll
    for (int d = 0; d < D; ++d) v[d] = __ldg(x + n * D + d);
}

// one level's features of one sample (zero where Takikawa's mask is empty)
template <int D, int F, bool TAKI>
__device__ __forceinline__ void encode_level(const XorLevel& lv, const float (&xv)[D], const float* __restrict__ table,
                                             const uint8_t* __restrict__ mask, float (&acc)[F]) {
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;
    const Cell<D, TAKI> c = cell_of<D, TAKI>(lv, xv, mask);
    if (!c.inside) return;
#pragma unroll
    for (int k = 0; k < (1 << D); ++k) {
        float dw[D];
        const float w = weight_of<D, TAKI>(c, k, dw);
        float r[F];
        load_row<F>(table + (size_t)slot_of<D, TAKI>(lv, c, k) * F, r);
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] += w * r[f];
    }
}

// K, levels concatenated: a thread per (sample, level), level fastest
template <int D, int F, bool TAKI>
__global__ void __launch_bounds__(kThreads)
xor_encode_kernel(const __grid_constant__ XorArgs a, const float* __restrict__ x, const float* __restrict__ table,
                  const uint8_t* __restrict__ mask, float* __restrict__ out, long long n) {
    const long long total = n * a.n_levels;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total; i += (long long)gridDim.x * blockDim.x) {
        const long long s = i / a.n_levels;
        const int l = (int)(i - s * a.n_levels);
        float xv[D];
        load_x<D>(x, s, xv);
        float acc[F];
        encode_level<D, F, TAKI>(a.lv[l], xv, table, mask, acc);
        store_row<F>(out + i * F, acc);
    }
}

// K, levels summed (Takikawa's sum_instead_of_concat): a thread per sample,
// the levels added in order
template <int D, int F>
__global__ void __launch_bounds__(kThreads)
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

// L: a thread per sample over its levels; dtable (zeroed) by atomics, dx
// summed in registers. Either output may be null.
template <int D, int F, bool TAKI>
__global__ void __launch_bounds__(kThreads)
xor_encode_bwd_kernel(const __grid_constant__ XorArgs a, const float* __restrict__ x, const float* __restrict__ table,
                      const uint8_t* __restrict__ mask, const float* __restrict__ dout, float* __restrict__ dtable,
                      float* __restrict__ dx, long long n) {
    const int L = a.n_levels;
    const int width = a.sum ? F : L * F;
    for (long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x; s < n; s += (long long)gridDim.x * blockDim.x) {
        float xv[D];
        load_x<D>(x, s, xv);
        float gx[D];
#pragma unroll
        for (int d = 0; d < D; ++d) gx[d] = 0.f;
        for (int l = 0; l < L; ++l) {
            const XorLevel& lv = a.lv[l];
            const Cell<D, TAKI> c = cell_of<D, TAKI>(lv, xv, mask);
            if (!c.inside) continue;
            float g[F];
            load_row<F>(dout + s * width + (a.sum ? 0 : l * F), g);
#pragma unroll
            for (int k = 0; k < (1 << D); ++k) {
                float dw[D];
                const float w = weight_of<D, TAKI>(c, k, dw);
                const uint32_t row = slot_of<D, TAKI>(lv, c, k);
                if (dtable) {
                    float v[F];
#pragma unroll
                    for (int f = 0; f < F; ++f) v[f] = w * g[f];
                    add_row<F>(dtable + (size_t)row * F, v);
                }
                if (dx) {
                    float r[F];
                    load_row<F>(table + (size_t)row * F, r);
                    float dot = 0.f;
#pragma unroll
                    for (int f = 0; f < F; ++f) dot += g[f] * r[f];
#pragma unroll
                    for (int d = 0; d < D; ++d) gx[d] += dot * dw[d] * c.ds[d];
                }
            }
        }
        if (dx) {
#pragma unroll
            for (int d = 0; d < D; ++d) dx[s * D + d] = gx[d];
        }
    }
}

int blocks_for(long long work) {
    long long b = (work + kThreads - 1) / kThreads;
    return (int)(b < 1 ? 1 : (b > (1LL << 30) ? (1LL << 30) : b));
}

template <int D, int F, bool TAKI>
int launch_fwd(const XorArgs& a, const float* x, const float* table, const uint8_t* mask, float* out, long long n,
               cudaStream_t stream) {
    if constexpr (TAKI) {  // only Takikawa sums its levels
        if (a.sum) {
            xor_encode_sum_kernel<D, F><<<blocks_for(n), kThreads, 0, stream>>>(a, x, table, mask, out, n);
            return (int)cudaGetLastError();
        }
    }
    xor_encode_kernel<D, F, TAKI><<<blocks_for(n * a.n_levels), kThreads, 0, stream>>>(a, x, table, mask, out, n);
    return (int)cudaGetLastError();
}

template <int D, int F, bool TAKI>
int launch_bwd(const XorArgs& a, const float* x, const float* table, const uint8_t* mask, const float* dout,
               float* dtable, float* dx, long long n, cudaStream_t stream) {
    xor_encode_bwd_kernel<D, F, TAKI><<<blocks_for(n), kThreads, 0, stream>>>(a, x, table, mask, dout, dtable, dx, n);
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

// 1 when L's table scatter was built with float2 / float4 atomics
extern "C" int nst_xor_vector_atomics() { return NST_VECTOR_ATOMICS; }
