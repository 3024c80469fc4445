// Kernel B: hash-grid encode forward (brick-layout slots, canonical table).
//
// Replaces the XLA-fused op GridEncoding._brick_fracs + make_brick_encode's
// _reference (nerfshop_tpu/models/encodings.py:270-300,
// nerfshop_tpu/ops/table_ops.py:239-244). It is the forward whose backward
// kernel A (segsum.cu) computes.
//
// Per (sample n, level l): p = x*scale_l + 0.5, base cell p0 = clamp(floor(p)),
// folded fracs w1 (0 on an axis where p0 == res-1), base slot
//   dense levels: x + res*(y + res*z)
//   hash levels:  (x + y*2654435761 + z*805459861) mod m   (uint32, m = 2^k)
// and the 8 corners read straight from the canonical [sum m, 2] table at
// (base + shift_c) mod m; no brick tables are built.
//   out [N, L*2] f32, idx [L, N] int32, w1 [L, N, 3] f32.
//
// What bounds it on the H100: random 8-byte table reads, 8 per (sample,
// level), i.e. 2^18 * 16 * 8 = 32 M scattered reads per training step; the
// coarse levels fit in L2, the 4 MB fine levels mostly do too.
//
// Design: one thread per (sample, level), samples fastest within a level
// (blockIdx.y = level), so the writes of idx and w1 and the reads of x are
// coalesced and neighbouring threads hit the same level's table region. Each
// corner is one float2 load. The p = x*scale + 0.5 step uses __fmul_rn and
// __fadd_rn so that no FMA contraction moves a sample across a cell boundary:
// the kernel and the plain PyTorch version agree on every slot.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMetaInts = 12;  // res, m, offset, dense, shift[8]

__global__ void grid_encode_kernel(const float* __restrict__ x, const int* __restrict__ meta_i,
                                   const float* __restrict__ meta_f,
                                   const float2* __restrict__ table, float2* __restrict__ out,
                                   int* __restrict__ idx_out, float* __restrict__ w1_out,
                                   int n, int n_levels) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int l = blockIdx.y;
    if (i >= n) return;
    const int* mi = meta_i + l * kMetaInts;
    const int res = mi[0];
    const uint32_t m = (uint32_t)mi[1];
    const int offset = mi[2];
    const int dense = mi[3];
    const float scale = meta_f[l];

    uint32_t cu[3];
    float w1[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        float p = __fadd_rn(__fmul_rn(__ldg(x + 3 * i + d), scale), 0.5f);
        float p0f = floorf(p);
        float frac = __fsub_rn(p, p0f);
        int p0 = (int)p0f;
        p0 = p0 < 0 ? 0 : (p0 > res - 1 ? res - 1 : p0);
        w1[d] = (p0 == res - 1) ? 0.f : frac;
        cu[d] = (uint32_t)p0;
    }
    uint32_t base;
    if (dense) {
        base = cu[0] + (uint32_t)res * (cu[1] + (uint32_t)res * cu[2]);
    } else {
        base = (cu[0] + cu[1] * 2654435761u + cu[2] * 805459861u) & (m - 1u);
    }

    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        float w = ((c & 1) ? w1[0] : 1.f - w1[0]);
        w = __fmul_rn(w, ((c & 2) ? w1[1] : 1.f - w1[1]));
        w = __fmul_rn(w, ((c & 4) ? w1[2] : 1.f - w1[2]));
        uint32_t s = base + (uint32_t)mi[4 + c];
        if (s >= m) s -= m;
        float2 v = __ldg(table + offset + s);
        acc0 = fmaf(w, v.x, acc0);
        acc1 = fmaf(w, v.y, acc1);
    }
    out[(size_t)i * n_levels + l] = make_float2(acc0, acc1);
    idx_out[(size_t)l * n + i] = (int)base;
    float* w1p = w1_out + ((size_t)l * n + i) * 3;
    w1p[0] = w1[0];
    w1p[1] = w1[1];
    w1p[2] = w1[2];
}

}  // namespace

extern "C" int nst_grid_encode(const void* x, const void* meta_i, const void* meta_f,
                               const void* table, void* out, void* idx, void* w1, int n,
                               int n_levels, void* stream) {
    const int threads = 256;
    dim3 grid((n + threads - 1) / threads, n_levels);
    if (n > 0 && n_levels > 0) {
        grid_encode_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
            (const float*)x, (const int*)meta_i, (const float*)meta_f, (const float2*)table,
            (float2*)out, (int*)idx, (float*)w1, n, n_levels);
    }
    return (int)cudaGetLastError();
}
