// Kernel A: per-row gradient sums over samples sorted by table slot.
//
// Replaces nerfshop_tpu/ops/pallas_segsum.py::sorted_segment_rowsum (the
// Pallas kernel behind the hash-table backward). Same inputs and output:
//   key_s  [N]    int32, sorted ascending, each in [0, m)
//   w1_s   [N, 3] f32 folded lerp fractions, in sorted order
//   dout_s [N, 2] f32 output cotangents, in sorted order
//   out    [m, 16] f32: row r = sum over n with key_n == r of w8_n (x) dout_n,
//          column c*2 + f (corner c, feature f), w8_c = prod_d lerp(w1_d).
//
// What bounds it on the H100: bytes, when the runs are short. Per level it
// reads N*(4+12+8) bytes of sorted samples once and writes m*64 bytes of
// output (32 MB at m = 2^19); the binary searches touch the 4*N-byte key
// array, which stays in the 50 MB L2. When one row holds a long run the
// bound is that run's serial length instead: in training a masked sample
// sits at its ray's origin, so the masked samples of a batch (often most
// of the 2^18) pile onto one slot per training camera per level.
//
// Design: two launches over disjoint rows, both deterministic and free of
// atomics.
//   1. One thread per output row finds the row's sample range by two
//      lower-bound searches, sums the run in fp32 registers if it holds at
//      most kShortRun samples, and writes the row with four 16-byte stores
//      (zeros where no sample hits the row). Longer rows are left alone.
//   2. One block per kShortRun-th sample: a run longer than kShortRun holds
//      at least one such sample, and the block at the first of them sums
//      the whole run, each thread over a strided slice, then a fixed-order
//      tree reduction in shared memory. Every other block exits after its
//      searches.
// The TPU design (block-local one-hot matmuls with bf16 hi+lo splits) is
// not carried over: a segmented sum over a sorted stream needs no matrix
// unit here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kShortRun = 32;
constexpr int kLongThreads = 256;

__device__ __forceinline__ int lower_bound(const int* __restrict__ keys, int n, int value) {
    int lo = 0, hi = n;
    while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (__ldg(keys + mid) < value) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

__device__ __forceinline__ void accumulate(const float* __restrict__ w1_s, const float2* __restrict__ dout_s,
                                           int s, float acc[16]) {
    float a0 = __ldg(w1_s + 3 * s + 0);
    float a1 = __ldg(w1_s + 3 * s + 1);
    float a2 = __ldg(w1_s + 3 * s + 2);
    float2 g = __ldg(dout_s + s);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        float w = ((c & 1) ? a0 : 1.f - a0);
        w = w * ((c & 2) ? a1 : 1.f - a1);
        w = w * ((c & 4) ? a2 : 1.f - a2);
        acc[2 * c + 0] += w * g.x;
        acc[2 * c + 1] += w * g.y;
    }
}

__global__ void segsum_short_kernel(const int* __restrict__ key_s, const float* __restrict__ w1_s,
                                    const float2* __restrict__ dout_s, float4* __restrict__ out,
                                    int n, int m) {
    int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= m) return;
    int s0 = lower_bound(key_s, n, r);
    int s1 = lower_bound(key_s, n, r + 1);
    if (s1 - s0 > kShortRun) return;  // written by segsum_long_kernel
    float acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0.f;
    for (int s = s0; s < s1; ++s) accumulate(w1_s, dout_s, s, acc);
    float4* row = out + 4 * (size_t)r;
#pragma unroll
    for (int q = 0; q < 4; ++q)
        row[q] = make_float4(acc[4 * q + 0], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
}

__global__ void segsum_long_kernel(const int* __restrict__ key_s, const float* __restrict__ w1_s,
                                   const float2* __restrict__ dout_s, float* __restrict__ out, int n) {
    __shared__ int bounds[2];
    __shared__ float part[kLongThreads][17];
    const int probe = blockIdx.x * kShortRun;
    if (threadIdx.x == 0) {
        int r = __ldg(key_s + probe);
        int s0 = lower_bound(key_s, n, r);
        int s1 = lower_bound(key_s, n, r + 1);
        // only long runs, and only the block at the run's first probe sample
        bool mine = (s1 - s0 > kShortRun) && ((s0 + kShortRun - 1) / kShortRun) * kShortRun == probe;
        bounds[0] = mine ? s0 : 0;
        bounds[1] = mine ? s1 : 0;
    }
    __syncthreads();
    const int s0 = bounds[0], s1 = bounds[1];
    if (s1 == 0) return;
    float acc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = 0.f;
    for (int s = s0 + threadIdx.x; s < s1; s += kLongThreads) accumulate(w1_s, dout_s, s, acc);
#pragma unroll
    for (int j = 0; j < 16; ++j) part[threadIdx.x][j] = acc[j];
    __syncthreads();
    for (int stride = kLongThreads / 2; stride > 0; stride >>= 1) {
        if (threadIdx.x < stride) {
#pragma unroll
            for (int j = 0; j < 16; ++j) part[threadIdx.x][j] += part[threadIdx.x + stride][j];
        }
        __syncthreads();
    }
    if (threadIdx.x < 16) out[16 * (size_t)__ldg(key_s + s0) + threadIdx.x] = part[0][threadIdx.x];
}

}  // namespace

extern "C" int nst_segsum(const void* key_s, const void* w1_s, const void* dout_s, void* out,
                          int n, int m, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int threads = 256;
    const int blocks = (m + threads - 1) / threads;
    if (blocks > 0) {
        segsum_short_kernel<<<blocks, threads, 0, st>>>(
            (const int*)key_s, (const float*)w1_s, (const float2*)dout_s, (float4*)out, n, m);
    }
    const int probes = (n + kShortRun - 1) / kShortRun;
    if (probes > 0) {
        segsum_long_kernel<<<probes, kLongThreads, 0, st>>>(
            (const int*)key_s, (const float*)w1_s, (const float2*)dout_s, (float*)out, n);
    }
    return (int)cudaGetLastError();
}
