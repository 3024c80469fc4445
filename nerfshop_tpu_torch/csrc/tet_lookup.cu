// Kernel E: point-in-tet lookup through a uniform-grid LUT of candidate tets.
//
// Replaces the candidate loop of the edit warp,
// nerfshop_tpu/editing/operators.py::tet_lookup (operators.py:74-139), which
// XLA runs as a lax.fori_loop over the LUT's widest cell (MT up to ~42) with
// about 12 elementwise ops on [N] arrays per candidate. Same semantics:
//   cell  = floor((p - bbox_lo) * inv_cell), flat (x*res + y)*res + z;
//           outside the LUT box every candidate scores -inf;
//   score = min(w0, w1, w2, w3), w1..w3 = rows of inv_e dotted with p - v0,
//           w0 = ((1 - w1) - w2) - w3; a running best with a strict '>', so
//           the earliest candidate in LUT order wins a tie;
//   found = best >= threshold (eps if eps > 0, else -near_miss);
//   tet   = the winner, 0 when nothing scored; bary from that tet's row.
// Inputs: cells [res^3, MT] int32 (front-packed, -1 padded), bbox_lo [3],
// inv_cell [3], table [Nt, 12] f32 = [v0 | inv_e row-major], p [N, 3].
// Outputs: found [N] bool (one byte), tet [N] int32, bary [N, 4] f32.
//
// What bounds it on the H100: bytes, and little of them. Per point it reads a
// 12-byte position, at most one LUT row and one 48-byte table row per
// candidate it visits (both mostly L2 hits: the table holds a few thousand
// tets), and writes 21 bytes.
//
// Design: one thread per point; it walks its own cell's list and stops at the
// first -1, so the work follows the cell's real fanout (a mean of ~6) instead
// of the widest cell's. Every product, sum and difference is rounded on its
// own (__fmul_rn, __fadd_rn, __fsub_rn): no FMA contraction moves a point
// across a cell or flips a containment test against the plain version, which
// computes the same expressions op by op.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float nan_min(float a, float b) {
    // jnp.minimum / torch.minimum propagate NaN; fminf would drop it
    return (a != a || b != b) ? CUDART_NAN_F : fminf(a, b);
}

__device__ __forceinline__ void bary_of(const float* __restrict__ r, float px, float py, float pz,
                                        float& w0, float& w1, float& w2, float& w3) {
    const float d0 = __fsub_rn(px, __ldg(r + 0));
    const float d1 = __fsub_rn(py, __ldg(r + 1));
    const float d2 = __fsub_rn(pz, __ldg(r + 2));
    w1 = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(r + 3), d0), __fmul_rn(__ldg(r + 4), d1)), __fmul_rn(__ldg(r + 5), d2));
    w2 = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(r + 6), d0), __fmul_rn(__ldg(r + 7), d1)), __fmul_rn(__ldg(r + 8), d2));
    w3 = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(r + 9), d0), __fmul_rn(__ldg(r + 10), d1)), __fmul_rn(__ldg(r + 11), d2));
    w0 = __fsub_rn(__fsub_rn(__fsub_rn(1.0f, w1), w2), w3);
}

__global__ void tet_lookup_kernel(const int* __restrict__ cells, const float* __restrict__ bbox_lo,
                                  const float* __restrict__ inv_cell, const float* __restrict__ table,
                                  const float* __restrict__ p, uint8_t* __restrict__ found,
                                  int* __restrict__ tet_out, float4* __restrict__ bary_out,
                                  int n, int res, int mt, float threshold) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float px = __ldg(p + 3 * (size_t)i + 0);
    const float py = __ldg(p + 3 * (size_t)i + 1);
    const float pz = __ldg(p + 3 * (size_t)i + 2);
    const float fx = floorf(__fmul_rn(__fsub_rn(px, __ldg(bbox_lo + 0)), __ldg(inv_cell + 0)));
    const float fy = floorf(__fmul_rn(__fsub_rn(py, __ldg(bbox_lo + 1)), __ldg(inv_cell + 1)));
    const float fz = floorf(__fmul_rn(__fsub_rn(pz, __ldg(bbox_lo + 2)), __ldg(inv_cell + 2)));
    const float fres = (float)res;
    const bool inb = fx >= 0.f && fx < fres && fy >= 0.f && fy < fres && fz >= 0.f && fz < fres;

    float best = -CUDART_INF_F;
    int best_t = 0;
    if (inb) {
        const long long ci = ((long long)(int)fx * res + (int)fy) * res + (int)fz;
        const int* __restrict__ row = cells + ci * mt;
        for (int c = 0; c < mt; ++c) {
            const int t = __ldg(row + c);
            if (t < 0) break;  // lists are front-packed
            float w0, w1, w2, w3;
            bary_of(table + 12 * (size_t)t, px, py, pz, w0, w1, w2, w3);
            const float score = nan_min(nan_min(w0, w1), nan_min(w2, w3));
            if (score > best) {
                best = score;
                best_t = t;
            }
        }
    }
    float w0, w1, w2, w3;
    bary_of(table + 12 * (size_t)best_t, px, py, pz, w0, w1, w2, w3);
    found[i] = best >= threshold ? 1 : 0;
    tet_out[i] = best_t;
    bary_out[i] = make_float4(w0, w1, w2, w3);
}

}  // namespace

extern "C" int nst_tet_lookup(const void* cells, const void* bbox_lo, const void* inv_cell, const void* table,
                              const void* p, void* found, void* tet, void* bary, int n, int res, int mt,
                              float threshold, void* stream) {
    if (n <= 0) return (int)cudaGetLastError();
    const int threads = 256;
    tet_lookup_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const int*)cells, (const float*)bbox_lo, (const float*)inv_cell, (const float*)table, (const float*)p,
        (uint8_t*)found, (int*)tet, (float4*)bary, n, res, mt, threshold);
    return (int)cudaGetLastError();
}
