// Kernel B: hash-grid encode forward (brick-layout slots, canonical table),
// and kernel F, its gradient with respect to the positions (after B below).
// B takes D = 3 (NeRF, SDF and Volume positions) and D = 2 (the Image
// testbed's pixel coordinates) as a template parameter; F takes D = 3.
//
// Replaces the XLA-fused op GridEncoding._brick_fracs + make_brick_encode's
// _reference (nerfshop_tpu/models/encodings.py:270-300,
// nerfshop_tpu/ops/table_ops.py:239-244). It is the forward whose backward
// kernel A (segsum.cu) computes.
//
// Per (sample n, level l): p = x*scale_l + 0.5, base cell p0 = clamp(floor(p)),
// folded fracs w1 (0 on an axis where p0 == res-1), base slot
//   dense levels: x + res*(y + res*z)                     (D = 2: x + res*y)
//   hash levels:  (x + y*2654435761 + z*805459861) mod m  (D = 2: x + y*2654435761;
//                                                          uint32, m = 2^k)
// and the 2^D corners read straight from the canonical [sum m, 2] table at
// (base + shift_c) mod m; no brick tables are built. Two modes:
//   with fracs:    out [N, L*2] f32, idx [L, N] int32, w1 [L, N, D] f32
//                  (the training forward: the backward reads idx and w1);
//   without fracs: out only (render, grid refresh, edited frames).
// The p = x*scale + 0.5 step uses __fmul_rn and __fadd_rn so that no FMA
// contraction moves a sample across a cell boundary, and the corners are
// summed in the order of the first version: the kernel and the plain PyTorch
// version agree on every slot, and both modes give the same out bit for bit.
//
// What bounds it on the H100: bytes. Per sample, x 12 B in and out 8L B;
// with fracs also idx 4L B and w1 12L B: 140 B (without) or 396 B (with) at
// L = 16, plus each table row the corners touch, 8 B once. Training, 2^18
// uniform samples with fracs: x, idx, w1, out and ~46 MB of the 46.5 MiB
// table, 150 MB (0.045 ms at 3.35 TB/s); 83 MB without fracs. One 1080p
// render chunk, 2^20 coherent positions without fracs: 147 MB of x and out
// and ~8 MB of table rows (0.046 ms). What the card reaches is further off:
// at random positions the corners read ~5 scattered 32-byte sectors per
// (sample, level) through L2, ~0.6 GB a training call, and at the frame
// shape the integer and float arithmetic of each (sample, level) sets the
// pace.
//
// What the first version (one thread per (sample, level), blockIdx.y = level)
// lost (device time 0.327 ms at the training shape, 7x the bound; 0.953 ms
// at the frame shape, 8x the bound of its full outputs and 21x that of the
// features alone, all a render needs):
//   1. a sample's 128-byte out row was finished by 16 level waves long apart,
//      8 bytes at a time, with neighbouring threads 128 bytes apart, so
//      sectors reached device memory in pieces once out (134 MB at the frame
//      shape) outgrew the 50 MB L2;
//   2. idx and w1, 16 of every 24 bytes written, were written under
//      torch.no_grad too, where nothing reads them;
//   3. x and the level metadata were read again for every level, and each
//      corner address took eight integer instructions;
//   4. the table reads shared L2 with the streaming outputs.
//
// Design (v2).
//   1. A block owns a tile of samples and a group of kGroup levels, and
//      writes the out bytes of that tile and group itself: the sums go to a
//      padded [tile][group + 1] stage in shared memory (no bank conflicts on
//      either side), then the block stores the tile's rows with 16-byte
//      streaming stores (st.global.cs, evict-first), neighbouring threads on
//      neighbouring addresses. With kGroup = L the tile's out is one
//      contiguous stretch.
//   2. The fracs-free mode is a template instance that writes out only.
//      With fracs, idx and w1 stay level-major and are written straight from
//      registers, a warp on 32 consecutive samples of one level (coalesced).
//   3. x and the group's level metadata are loaded once per block into
//      shared memory (three 16-byte loads of metadata per level, a
//      broadcast); a corner's slot is one add and one add-min, its address
//      one 64-bit shift-add from the level's base.
//   4. The outputs stream past L2 (.cs). An L2 evict_last policy on the
//      table reads (createpolicy + ld.global.nc.L2::cache_hint) was measured
//      and moved no case beyond +-0.005 ms, so the table is read through the
//      non-coherent path without one.
//   A thread handles one sample at up to kLevelsPerThread levels of its
//   block's group and issues all their corner loads (up to 32 8-byte loads)
//   before any sum, so the fine levels' misses overlap.
//
// Level grouping: 16 levels per block (whole 128-byte rows), fixed. It was
// chosen on an H100 80GB HBM3 at 700 W against groups of 4 (whole 32-byte
// sectors, a level-group-major grid with ~16 MiB of table in play), each
// built from this kernel and timed by device time at both shapes (PERF.md,
// Findings). 16 / 4 levels: training shape 0.2654 / 0.1997 ms with fracs,
// 0.2380 / 0.1876 without; frame shape 0.1713 / 0.2516 without fracs,
// 0.2099 / 0.3119 with. 4 wins at random positions, where the whole table is
// in play under 16; 16 wins at the frame shape, which every render, frame()
// and edited-frame launch has (254 launches a 1080p frame), by more.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLevelsPerThread = 4;
constexpr int kGroup = 16;  // levels a block covers (the note above)
constexpr int kMetaInts = 12;  // per level: res, m, offset, dense, 8 corner shifts

// Threads per sample for a block of `group` levels: each takes at most
// kLevelsPerThread of them.
__host__ __device__ inline int threads_per_sample(int group) {
    return group > 2 * kLevelsPerThread ? 4 : (group > kLevelsPerThread ? 2 : 1);
}

// row `slot` of a level's table (tl, 64-bit) in one mad.wide.u32: the
// compiler would otherwise widen offset + slot in four instructions
__device__ __forceinline__ float2 load_row(const float2* tl, uint32_t slot) {
    uint64_t a;
    asm("mad.wide.u32 %0, %1, 8, %2;" : "=l"(a) : "r"(slot), "l"(reinterpret_cast<uint64_t>(tl)));
    return __ldg(reinterpret_cast<const float2*>(a));
}

// (base + shift) mod m for base, shift < m < 2^31: one of the two is below m
__device__ __forceinline__ uint32_t wrap(uint32_t base, uint32_t shift, uint32_t m) {
    const uint32_t t = base + shift;
    return min(t, t - m);
}

template <int D, bool kFracs>
__global__ void __launch_bounds__(kThreads)
grid_encode_kernel(const float* __restrict__ x, const int* __restrict__ meta_i,
                   const float* __restrict__ meta_f, const float2* __restrict__ table,
                   float2* __restrict__ out, int* __restrict__ idx_out, float* __restrict__ w1_out,
                   int n, int n_levels, int group) {
    constexpr int C = 1 << D;  // cell corners
    extern __shared__ int4 smem[];
    const int spt = threads_per_sample(group);
    const int tile = kThreads / spt;
    const int stride = group + 1;  // padded stage row, in float2
    int4* s_mi = smem;  // [group, 3] int4: res, m, offset, dense | shifts 0-3 | shifts 4-7
    float* s_scale = reinterpret_cast<float*>(s_mi + 3 * group);  // [group]
    float* s_x = s_scale + group;  // [tile, D]
    float2* s_out = reinterpret_cast<float2*>(s_x + D * tile + (group & 1));  // [tile, group + 1]

    const int n0 = blockIdx.x * tile;
    const int l0 = blockIdx.y * group;
    const int gl = min(group, n_levels - l0);  // this block's levels
    const int rows = min(tile, n - n0);
    const float* xt = x + (size_t)n0 * D;
    int* s_mi_flat = reinterpret_cast<int*>(s_mi);
#pragma unroll 1
    for (int k = threadIdx.x; k < D * rows; k += kThreads) s_x[k] = __ldcs(xt + k);
#pragma unroll 1
    for (int k = threadIdx.x; k < gl * kMetaInts; k += kThreads) s_mi_flat[k] = meta_i[l0 * kMetaInts + k];
    if (threadIdx.x < gl) s_scale[threadIdx.x] = meta_f[l0 + threadIdx.x];
    __syncthreads();

    const int s = threadIdx.x % tile;
    const int j = threadIdx.x / tile;
    if (s < rows) {
        float xs[D];
#pragma unroll
        for (int d = 0; d < D; ++d) xs[d] = s_x[D * s + d];
        float w1[kLevelsPerThread][D];
        uint32_t base[kLevelsPerThread];
        float2 v[kLevelsPerThread][C];
#pragma unroll
        for (int k = 0; k < kLevelsPerThread; ++k) {
            const int ll = j + k * spt;
            if (ll < gl) {
                const int4 hdr = s_mi[3 * ll];
                const int4 sa = s_mi[3 * ll + 1], sb = s_mi[3 * ll + 2];
                const int res = hdr.x;
                const float scale = s_scale[ll];
                uint32_t cu[D];
#pragma unroll
                for (int d = 0; d < D; ++d) {
                    float p = __fadd_rn(__fmul_rn(xs[d], scale), 0.5f);
                    float p0f = floorf(p);
                    float frac = __fsub_rn(p, p0f);
                    int p0 = min(max((int)p0f, 0), res - 1);
                    w1[k][d] = (p0 == res - 1) ? 0.f : frac;
                    cu[d] = (uint32_t)p0;
                }
                const uint32_t m = (uint32_t)hdr.y;
                if (D == 3) {
                    if (hdr.w) {
                        base[k] = cu[0] + (uint32_t)res * (cu[1] + (uint32_t)res * cu[D - 1]);
                    } else {
                        base[k] = (cu[0] + cu[1] * 2654435761u + cu[D - 1] * 805459861u) & (m - 1u);
                    }
                } else {
                    base[k] = hdr.w ? cu[0] + (uint32_t)res * cu[1] : (cu[0] + cu[1] * 2654435761u) & (m - 1u);
                }
                const float2* tl = table + hdr.z;
                const uint32_t sh[8] = {(uint32_t)sa.x, (uint32_t)sa.y, (uint32_t)sa.z, (uint32_t)sa.w,
                                        (uint32_t)sb.x, (uint32_t)sb.y, (uint32_t)sb.z, (uint32_t)sb.w};
#pragma unroll
                for (int c = 0; c < C; ++c) v[k][c] = load_row(tl, wrap(base[k], sh[c], m));
            }
        }
#pragma unroll
        for (int k = 0; k < kLevelsPerThread; ++k) {
            const int ll = j + k * spt;
            if (ll < gl) {
                float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    float w = ((c & 1) ? w1[k][0] : 1.f - w1[k][0]);
#pragma unroll
                    for (int d = 1; d < D; ++d) w = __fmul_rn(w, ((c >> d) & 1) ? w1[k][d] : 1.f - w1[k][d]);
                    acc0 = fmaf(w, v[k][c].x, acc0);
                    acc1 = fmaf(w, v[k][c].y, acc1);
                }
                s_out[s * stride + ll] = make_float2(acc0, acc1);
                if (kFracs) {
                    const size_t li = (size_t)(l0 + ll) * n + n0 + s;
                    __stcs(idx_out + li, (int)base[k]);
                    float* w1p = w1_out + li * D;
#pragma unroll
                    for (int d = 0; d < D; ++d) __stcs(w1p + d, w1[k][d]);
                }
            }
        }
    }
    __syncthreads();

    // the tile's out rows for this group: 16-byte streaming stores where the
    // row pieces allow (always for even L), neighbouring threads on
    // neighbouring addresses; one contiguous stretch when gl == n_levels
    // (row r, piece c) of q advance by kThreads pieces a step, without a division
    const int vec = (gl | l0 | n_levels) % 2 == 0 ? 2 : 1;
    const int per = gl / vec;
    int r = threadIdx.x / per, c = threadIdx.x - r * per;
    const int dr = kThreads / per, dc = kThreads - dr * per;
    for (; r < rows; r += dr, c += dc) {
        if (c >= per) c -= per, ++r;
        if (r >= rows) break;
        float2* dst = out + (size_t)(n0 + r) * n_levels + l0 + vec * c;
        const float2* src = s_out + r * stride + vec * c;
        if (vec == 2) {
            __stcs(reinterpret_cast<float4*>(dst), make_float4(src[0].x, src[0].y, src[1].x, src[1].y));
        } else {
            __stcs(dst, src[0]);
        }
    }
}

// Kernel F: the encode's gradient with respect to the positions.
//
// Replaces what JAX takes by autodiff through the custom VJP of the brick
// encode (nerfshop_tpu/ops/table_ops.py:263-267, d_w8 from the saved
// features) and back through corner_products and _brick_fracs
// (nerfshop_tpu/models/encodings.py:270-300):
//   d_x[n, d] = sum_l scale_l [p0_d != res_l - 1]
//               sum_c dw8_c/dw1_d sum_f dout[n, l, f] table[row(l, n, c), f].
// p, p0, the folded fractions, the base slot and the corner rows are
// recomputed from x with kernel B's arithmetic above (the same rounding
// steps, the same hash and wrap), so it needs none of B's saved slots or
// fractions and reads exactly the rows B read.
//
// What bounds it on the H100: bytes, like B: x 12 B, dout 8L B and d_x 12 B
// a sample, and every table row the corners touch, 8 B once; the corner
// reads are as scattered as B's.
//
// Design (a first version, simple and right): kFLanes threads own a sample,
// each a quarter of its levels (l = lane, lane + 4, ...); a thread issues its
// level's 8 corner loads, dots each row with the level's dout pair, forms
// the three fraction derivatives in registers, and the lanes of a sample
// (neighbours in one warp) sum their partial d_x with two shuffles. No
// atomics, no shared memory; a sample's d_x is written once by its first
// lane.
constexpr int kFLanes = 4;

__global__ void __launch_bounds__(kThreads)
grid_encode_dx_kernel(const float* __restrict__ x, const int* __restrict__ meta_i,
                      const float* __restrict__ meta_f, const float2* __restrict__ table,
                      const float2* __restrict__ dout, float* __restrict__ dx, int n, int n_levels) {
    const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
    const long long s = t / kFLanes;
    const int lane = threadIdx.x % kFLanes;
    float acc[3] = {0.f, 0.f, 0.f};
    if (s < n) {
        const float xs[3] = {__ldg(x + 3 * s), __ldg(x + 3 * s + 1), __ldg(x + 3 * s + 2)};
#pragma unroll 1
        for (int l = lane; l < n_levels; l += kFLanes) {
            const int* mi = meta_i + l * kMetaInts;
            const int res = __ldg(mi);
            const uint32_t m = (uint32_t)__ldg(mi + 1);
            const float scale = __ldg(meta_f + l);
            float w1[3];
            bool moves[3];
            uint32_t cu[3];
#pragma unroll
            for (int d = 0; d < 3; ++d) {
                float p = __fadd_rn(__fmul_rn(xs[d], scale), 0.5f);
                float p0f = floorf(p);
                float frac = __fsub_rn(p, p0f);
                int p0 = min(max((int)p0f, 0), res - 1);
                moves[d] = p0 != res - 1;
                w1[d] = moves[d] ? frac : 0.f;
                cu[d] = (uint32_t)p0;
            }
            uint32_t base;
            if (__ldg(mi + 3)) {
                base = cu[0] + (uint32_t)res * (cu[1] + (uint32_t)res * cu[2]);
            } else {
                base = (cu[0] + cu[1] * 2654435761u + cu[2] * 805459861u) & (m - 1u);
            }
            const float2* tl = table + __ldg(mi + 2);
            const float2 g = dout[s * n_levels + l];
            float gc[8];
#pragma unroll
            for (int c = 0; c < 8; ++c) {
                const float2 v = load_row(tl, wrap(base, (uint32_t)__ldg(mi + 4 + c), m));
                gc[c] = fmaf(g.x, v.x, g.y * v.y);
            }
#pragma unroll
            for (int d = 0; d < 3; ++d) {
                // dw8_c/dw1_d: the other two axes' factors, + where bit d of c is set
                float dw = 0.f;
#pragma unroll
                for (int c = 0; c < 8; ++c) {
                    float w = 1.f;
#pragma unroll
                    for (int e = 0; e < 3; ++e) {
                        if (e != d) w *= ((c >> e) & 1) ? w1[e] : 1.f - w1[e];
                    }
                    dw = ((c >> d) & 1) ? fmaf(w, gc[c], dw) : fmaf(-w, gc[c], dw);
                }
                if (moves[d]) acc[d] = fmaf(scale, dw, acc[d]);
            }
        }
    }
#pragma unroll
    for (int o = 1; o < kFLanes; o <<= 1) {
#pragma unroll
        for (int d = 0; d < 3; ++d) acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], o);
    }
    if (s < n && lane == 0) {
        dx[3 * s] = acc[0];
        dx[3 * s + 1] = acc[1];
        dx[3 * s + 2] = acc[2];
    }
}

}  // namespace

// samples per block of a launch at n_levels levels (the tile that
// nst_grid_encode uses)
extern "C" int nst_grid_encode_tile(int n_levels) {
    return kThreads / threads_per_sample(n_levels < kGroup ? n_levels : kGroup);
}

template <int D>
static void launch_encode(dim3 grid, size_t smem, cudaStream_t st, const void* x, const void* meta_i,
                          const void* meta_f, const void* table, void* out, void* idx, void* w1, int n,
                          int n_levels, int group) {
    if (idx != nullptr) {
        grid_encode_kernel<D, true><<<grid, kThreads, smem, st>>>(
            (const float*)x, (const int*)meta_i, (const float*)meta_f, (const float2*)table, (float2*)out,
            (int*)idx, (float*)w1, n, n_levels, group);
    } else {
        grid_encode_kernel<D, false><<<grid, kThreads, smem, st>>>(
            (const float*)x, (const int*)meta_i, (const float*)meta_f, (const float2*)table, (float2*)out,
            nullptr, nullptr, n, n_levels, group);
    }
}

// x [n, d] f32, d = 2 or 3; meta_i [L, 12] int32 (res, m, offset, dense, 8
// shifts, the last 4 unused at d = 2) and meta_f [L] f32 (scales) on the
// device; idx and w1 are null in the fracs-free mode.
extern "C" int nst_grid_encode(const void* x, const void* meta_i, const void* meta_f, const void* table,
                               void* out, void* idx, void* w1, int n, int n_levels, int d, void* stream) {
    if (n_levels < 0 || (d != 2 && d != 3) || (idx == nullptr) != (w1 == nullptr)) return (int)cudaErrorInvalidValue;
    if (n == 0 || n_levels == 0) return (int)cudaGetLastError();
    const int group = n_levels < kGroup ? n_levels : kGroup;
    const int tile = nst_grid_encode_tile(n_levels);
    const dim3 grid((n + tile - 1) / tile, (n_levels + group - 1) / group);
    const size_t smem = (size_t)group * (3 * sizeof(int4) + sizeof(float)) + (size_t)tile * d * sizeof(float) +
                        (group & 1) * sizeof(float) + (size_t)tile * (group + 1) * sizeof(float2);
    cudaStream_t st = (cudaStream_t)stream;
    if (d == 3) launch_encode<3>(grid, smem, st, x, meta_i, meta_f, table, out, idx, w1, n, n_levels, group);
    else launch_encode<2>(grid, smem, st, x, meta_i, meta_f, table, out, idx, w1, n, n_levels, group);
    return (int)cudaGetLastError();
}


// Kernel F: dx [N, 3] f32 from x [N, 3], the table, dout [N, L*2] (8-byte
// aligned) and kernel B's level metadata.
extern "C" int nst_grid_encode_dx(const void* x, const void* meta_i, const void* meta_f, const void* table,
                                  const void* dout, void* dx, int n, int n_levels, void* stream) {
    if (n < 0 || n_levels < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const long long threads = (long long)n * kFLanes;
    const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads));
    grid_encode_dx_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const int*)meta_i, (const float*)meta_f, (const float2*)table, (const float2*)dout,
        (float*)dx, n, n_levels);
    return (int)cudaGetLastError();
}
