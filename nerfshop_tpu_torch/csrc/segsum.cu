// Kernel A: per-row gradient sums over samples sorted by table slot.
//
// Replaces nerfshop_tpu/ops/pallas_segsum.py::sorted_segment_rowsum (the
// Pallas kernel behind the hash-table backward). Same inputs and output:
//   key_s  [N]    int32, sorted ascending, each in [0, m)
//   w1_s   [N, D] f32 folded lerp fractions, in sorted order
//   dout_s [N, F] f32 output cotangents, in sorted order
//   out    [m, W] f32, W = 2^D * F: row r = sum over n with key_n == r of
//          w8_n (x) dout_n, column c*F + f (corner c, feature f),
//          w8_c = prod_d lerp(w1_d).
// D is a template parameter: 3 (NeRF, SDF and Volume) or 2 (the Image
// testbed's 2-D grid); so is F, the features a level: 2 (16-float rows at
// D = 3, 8 at D = 2) or 4 (configs/nerf/tpu_hash_fast.json: 32-float rows,
// 128 bytes, at D = 3, 16 at D = 2). The numbers below are D = 3, F = 2's.
// At F = 4, D = 3 a tile's closed runs (512 rows of 128 bytes) outgrow the
// 48 KB of static shared memory, so that instance stages them in dynamic
// shared memory (64 KB a block, 3 blocks an SM), and the second launch
// sweeps 2 steps of 32 tiles before a ballot round instead of 4, so that a
// lane's pieces stay in registers.
//
// What bounds it on the H100: bytes, N*24 + m*64 per level (each sample read
// once, each row written once: 6.3 + 33.5 = 39.8 MB at N = 2^18, m = 2^19).
// The 48 floating-point operations per sample are far below the card's rate,
// and tensor cores do not apply: a segmented sum over a sorted stream has no
// matrix product in it.
//
// Design (v3), sample-major, deterministic, no atomics, two launches:
//   1. One block of kThreads threads per tile of kTile consecutive samples.
//      Each thread loads its kPer samples with 16-byte loads (keys, fractions
//      and cotangents are read once, coalesced; 4-byte loads where a view is
//      not 16-byte aligned), forms the 8 corner weights x 2 features and sums
//      runs of equal keys in registers. A run that closes inside the thread
//      goes to shared memory at once. The run open at the thread's end is
//      carried across threads by a segmented inclusive scan on head flags:
//      shuffles within a warp, then the warps' totals through shared memory,
//      in a fixed order; the thread holding a run's last sample in the tile
//      closes it. The tile owns the rows from its first key (0 for the first
//      tile) to the next tile's first key (m after the last); these stretches
//      cover [0, m) once. A stretch of at most kLong rows the block writes
//      itself, in rounds of kWindow rows, 16 bytes a thread, consecutive
//      threads on consecutive addresses, each row the run that closed on it
//      or zeros. In a longer stretch (sparse keys: one block would write it
//      at one SM's share of the bandwidth) each run's row is written by the
//      thread that closed it, and launch 2 writes the zeros. So every row of
//      out is written exactly once, and no memset runs.
//   2. One grid of two kinds of blocks:
//      - Runs that cross a tile edge: the tile writes its in-tile piece of
//        its first run (when that run comes from the previous tile) to
//        scratch[tile][0] and of its last run (when it goes on into the next
//        tile) to scratch[tile][1], and leaves the row to this launch. One
//        warp per tile where such a run starts finds the run's last tile (its
//        lanes test 32 tile edges at once), sums the pieces in a fixed order
//        (lanes over tiles, then a butterfly) and writes the row. The skewed
//        case of a training batch (most samples masked onto one slot, ~400
//        tiles) is one warp's read of 400 x 64 bytes, 128 tiles per round
//        trip.
//      - Zeros of the long stretches: one block per kFill rows of out finds
//        the tiles that own its first and last row (a warp searches the
//        tiles' first keys, 32 at a time), and for each long one marks the
//        tile's keys in shared memory and zeroes the other rows. Only those
//        two tiles can own a long stretch in it (kLong >= kFill), so the
//        zeros of a stretch of any length are spread over its blocks.
//      It is a programmatic dependent launch (Hopper): scheduled once every
//      tile block has started, so the gap between the launches is hidden.
//      Every thread of it executes griddepcontrol.wait before it exits (the
//      crossing runs before reading the scratch, the zero blocks after their
//      writes, which need nothing of launch 1), so launch 2 ends only after
//      launch 1 has ended and its writes are visible: the next work on the
//      stream sees all of out.
//   N = 0 writes the zeros with one cudaMemsetAsync instead.
// What is left between it and its bound: the tile kernel's chain (load,
// scan, barrier, write) runs once per block with ~4 blocks per SM; see
// PERF.md. The TPU design (block-local one-hot matmuls with bf16 hi+lo
// splits) is not carried over: a segmented sum needs no matrix unit here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPer = 4;  // samples per thread
constexpr int kTile = kThreads * kPer;  // samples per block; ops/segsum.py TILE
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 512;  // rows of out a block writes per round
// second launch: steps of 32 tiles read before one ballot round (the
// pieces a lane holds: 4 of 16 floats at F = 2, 2 of 32 at F = 4)
__host__ __device__ constexpr int sweep_steps(int f) { return 8 / f; }
constexpr int kFill = 2048;  // rows of out per zero block of the second launch
constexpr int kLong = kFill;  // a tile owning more rows than this leaves their zeros to the second launch
constexpr int kEdgeThreads = 256;  // threads per block of the second launch
constexpr unsigned kFull = 0xffffffffu;

// row width in floats (W) and in float4 (Q) at D and F; whether the tile
// kernel's closed runs go to dynamic shared memory (more than 48 KB)
template <int D, int F>
struct Row {
    static constexpr int W = (1 << D) * F;
    static constexpr int Q = W / 4;
    static constexpr bool kDynamic = sizeof(float4) * kTile * Q > 48 * 1024;
};

template <int D, int F>
__device__ __forceinline__ void add_sample(float* acc, const float* a, const float* g) {
#pragma unroll
    for (int c = 0; c < (1 << D); ++c) {
        float w = ((c & 1) ? a[0] : 1.f - a[0]);
#pragma unroll
        for (int d = 1; d < D; ++d) w = w * (((c >> d) & 1) ? a[d] : 1.f - a[d]);
#pragma unroll
        for (int f = 0; f < F; ++f) acc[F * c + f] += w * g[f];
    }
}

template <int D, int F, typename Dst>
__device__ __forceinline__ void store_row(Dst* dst, const float* v) {
#pragma unroll
    for (int q = 0; q < Row<D, F>::Q; ++q) dst[q] = make_float4(v[4 * q + 0], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

template <int D, int F>
__device__ __forceinline__ void store_scratch(float* scratch, int tile, int slot, const float* v) {
    store_row<D, F>(reinterpret_cast<float4*>(scratch + (2 * (size_t)tile + slot) * Row<D, F>::W), v);
}

template <int D, int F, bool kVec>
__global__ void __launch_bounds__(kThreads) segsum_tile_kernel(const int* __restrict__ key_s,
                                                                const float* __restrict__ w1_s,
                                                                const float* __restrict__ dout_s,
                                                                float4* __restrict__ out, float* __restrict__ scratch,
                                                                int n, int m) {
    constexpr int W = Row<D, F>::W, Q = Row<D, F>::Q;
    // rows of the runs that closed, by (thread, sample)
    float4 (*vals)[Q];
    if constexpr (Row<D, F>::kDynamic) {
        extern __shared__ float4 seg_dyn[];
        vals = reinterpret_cast<float4 (*)[Q]>(seg_dyn);
    } else {
        __shared__ float4 seg_vals[kTile][Q];
        vals = seg_vals;
    }
    __shared__ int slot_of[kWindow];  // a round's rows → their entry of vals, or -1
    __shared__ float warp_sum[kWarps][W];
    __shared__ int warp_reset[kWarps];
    const int tile = blockIdx.x;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int base = tile * kTile;
    const int tile_end = min(base + kTile, n);
    const int s0 = base + t * kPer;
    // the second launch may be scheduled as soon as every tile block has started
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");

    // this thread's samples; past n the key is m (a run that is never written)
    int k[kPer];
    float w[D * kPer], g[F * kPer];
    if (kVec && s0 + kPer <= n) {
        const int4 kk = __ldg(reinterpret_cast<const int4*>(key_s + s0));
        k[0] = kk.x; k[1] = kk.y; k[2] = kk.z; k[3] = kk.w;
#pragma unroll
        for (int q = 0; q < D; ++q) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(w1_s + D * (size_t)s0) + q);
            w[4 * q + 0] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z; w[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int q = 0; q < F; ++q) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(dout_s + F * (size_t)s0) + q);
            g[4 * q + 0] = v.x; g[4 * q + 1] = v.y; g[4 * q + 2] = v.z; g[4 * q + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
            const int s = s0 + j;
            const bool in = s < n;
            k[j] = in ? __ldg(key_s + s) : m;
#pragma unroll
            for (int d = 0; d < D; ++d) w[D * j + d] = in ? __ldg(w1_s + D * (size_t)s + d) : 0.f;
#pragma unroll
            for (int f = 0; f < F; ++f) g[F * j + f] = in ? __ldg(dout_s + F * (size_t)s + f) : 0.f;
        }
    }
    const int key_next = s0 + kPer < n ? __ldg(key_s + s0 + kPer) : m;
    const int key_prev = t == 0 ? -1 : (s0 - 1 < n ? __ldg(key_s + s0 - 1) : m);
    const int tile_first = __ldg(key_s + base);
    const bool open_left = tile > 0 && __ldg(key_s + base - 1) == tile_first;
    const bool open_right = tile_end < n && __ldg(key_s + tile_end) == __ldg(key_s + tile_end - 1);

    // runs inside the thread, in sample order; a run that closes at sample j
    // goes to vals[t * kPer + j] (bit j of to_out), the first one (closed
    // at jh) gets its carry from the threads before after the scan
    float acc[W];
#pragma unroll
    for (int i = 0; i < W; ++i) acc[i] = 0.f;
    unsigned to_out = 0;
    int jh = -1;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        add_sample<D, F>(acc, w + D * j, g + F * j);
        if (j + 1 < kPer && k[j] != k[j + 1]) {
            store_row<D, F>(vals[t * kPer + j], acc);
            if (jh < 0) jh = j;
            to_out |= 1u << j;
#pragma unroll
            for (int i = 0; i < W; ++i) acc[i] = 0.f;
        }
    }
    const bool multi = jh >= 0;

    // segmented inclusive scan of the open run over the tile's threads:
    // v(t) = acc(t) + (continues(t) ? v(t-1) : 0)
    const bool carry = k[0] == key_prev;  // the thread's first run comes from the thread before
    bool reset = multi || !carry;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        float u[W];
#pragma unroll
        for (int i = 0; i < W; ++i) u[i] = __shfl_up_sync(kFull, acc[i], d);
        const bool ur = __shfl_up_sync(kFull, (int)reset, d);
        if (lane >= d) {
            if (!reset) {
#pragma unroll
                for (int i = 0; i < W; ++i) acc[i] = u[i] + acc[i];
            }
            reset = reset || ur;
        }
    }
    if (lane == 31) {
#pragma unroll
        for (int i = 0; i < W; ++i) warp_sum[warp][i] = acc[i];
        warp_reset[warp] = reset;
    }
    __syncthreads();
    float pre[W];  // inclusive value at the last thread of the previous warp
#pragma unroll
    for (int i = 0; i < W; ++i) pre[i] = 0.f;
    for (int v = 0; v < warp; ++v) {
        const bool r = warp_reset[v];
#pragma unroll
        for (int i = 0; i < W; ++i) pre[i] = r ? warp_sum[v][i] : pre[i] + warp_sum[v][i];
    }
    if (!reset) {
#pragma unroll
        for (int i = 0; i < W; ++i) acc[i] = pre[i] + acc[i];
    }
    float prev[W];  // inclusive value at the thread before
#pragma unroll
    for (int i = 0; i < W; ++i) {
        const float up = __shfl_up_sync(kFull, acc[i], 1);
        prev[i] = lane == 0 ? pre[i] : up;
    }

    // the thread's first run, when it closed inside the thread: add the
    // carry; if it came from the previous tile it is this tile's slot 0
    if (multi) {
        float4* hv = vals[t * kPer + jh];
        float h[W];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const float4 v = hv[q];
            h[4 * q + 0] = v.x; h[4 * q + 1] = v.y; h[4 * q + 2] = v.z; h[4 * q + 3] = v.w;
        }
        if (carry) {
#pragma unroll
            for (int i = 0; i < W; ++i) h[i] = prev[i] + h[i];
            store_row<D, F>(hv, h);
        }
        if (open_left && k[0] == tile_first) {
            store_scratch<D, F>(scratch, tile, 0, h);
            to_out &= ~(1u << jh);
        }
    }
    // the run open at the thread's end closes here if the next sample has
    // another key or the tile ends
    const int kl = k[kPer - 1];
    const bool tile_last = s0 + kPer == tile_end;
    if (kl < m && (key_next != kl || tile_last)) {
        const bool first_piece = open_left && kl == tile_first;
        const bool last_piece = open_right && tile_last;
        if (first_piece) store_scratch<D, F>(scratch, tile, 0, acc);
        if (last_piece) store_scratch<D, F>(scratch, tile, 1, acc);
        if (!first_piece && !last_piece) {
            store_row<D, F>(vals[t * kPer + kPer - 1], acc);
            to_out |= 1u << (kPer - 1);
        }
    }

    // the tile's rows [r0, r1): from its first key (0 for the first tile) to
    // the next tile's first key (m after the last tile), without the row of
    // a run that came from the previous tile (the second launch writes it).
    const int r0 = tile == 0 ? 0 : tile_first;
    const int r1 = tile_end < n ? __ldg(key_s + tile_end) : m;
    if (r1 - r0 > kLong) {  // block-uniform: the rows of the runs only, the second launch writes the zeros
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
            if ((to_out >> j) & 1u) {
                float4* dst = out + Q * (size_t)k[j];
#pragma unroll
                for (int q = 0; q < Q; ++q) dst[q] = vals[t * kPer + j][q];
            }
        }
        return;
    }
    // Each round maps kWindow rows to the runs that closed on them, then the
    // block writes the rows in order, 16 bytes a thread, zeros where no run
    // closed: every row of the stretch is written once, coalesced.
    const int skip = open_left ? tile_first : -1;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int lo = r0; lo < r1; lo += kWindow) {
        for (int i = t; i < kWindow; i += kThreads) slot_of[i] = -1;
        __syncthreads();
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
            const int r = k[j] - lo;
            if (((to_out >> j) & 1u) && r >= 0 && r < kWindow) slot_of[r] = t * kPer + j;
        }
        __syncthreads();
        const int nq = Q * min(kWindow, r1 - lo);
        float4* dst = out + Q * (size_t)lo;
        for (int i = t; i < nq; i += kThreads) {
            if (lo + i / Q == skip) continue;
            const int slot = slot_of[i / Q];
            dst[i] = slot < 0 ? zero : vals[slot][i % Q];
        }
        __syncthreads();
    }
}

// one warp per tile: where a run starts in this tile and goes on past its
// end, sum the run's pieces in tile order and write its row
// (scratch is written by launch 1 while this grid may already run, so it is
// read with plain loads, not through the read-only path)
template <int D, int F>
__device__ void cross_run(const int* __restrict__ key_s, const float* scratch, float4* __restrict__ out, int n,
                          int tiles) {
    constexpr int W = Row<D, F>::W, Q = Row<D, F>::Q;
    constexpr int kSweep = sweep_steps(F);
    const int tile = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    // the keys are inputs: read them before the wait
    const int base = tile * kTile;
    const int end = min(base + kTile, n);
    const int key = tile < tiles ? __ldg(key_s + end - 1) : 0;
    const int first = tile < tiles ? __ldg(key_s + base) : 0;
    const bool open_right = tile < tiles && end < n && __ldg(key_s + end) == key;
    const bool open_left = tile > 0 && tile < tiles && __ldg(key_s + base - 1) == first;
    asm volatile("griddepcontrol.wait;" ::: "memory");  // the tile launch has finished and its scratch is visible
    if (!open_right || (open_left && first == key)) return;  // no run starts here and crosses the end (whole warps)
    // the run's pieces: lane l sums tiles tile + 1 + l, + 33 + l, ... in
    // order, 32 tiles a step, up to the first tile whose successor does not
    // start with the key (the run's last tile). A sweep reads kSweep steps'
    // pieces and keys before its ballots, so 32 * kSweep tiles cost one
    // round trip; pieces past the run's end are read and never added
    float acc[W];
#pragma unroll
    for (int i = 0; i < W; ++i) acc[i] = lane == 0 ? scratch[(2 * (size_t)tile + 1) * W + i] : 0.f;
    for (int j0 = tile + 1;; j0 += 32 * kSweep) {
        float4 piece[kSweep][Q];
        bool ends[kSweep];
#pragma unroll
        for (int u = 0; u < kSweep; ++u) {
            const int j = j0 + 32 * u + lane;
            if (j < tiles) {
                const float4* src = reinterpret_cast<const float4*>(scratch + (2 * (size_t)j + 0) * W);
#pragma unroll
                for (int q = 0; q < Q; ++q) piece[u][q] = src[q];
            }
            const int j_end = min((j + 1) * kTile, n);
            ends[u] = j >= tiles || j_end >= n || __ldg(key_s + j_end) != key;
        }
        bool done = false;
#pragma unroll
        for (int u = 0; u < kSweep; ++u) {
            const unsigned found = __ballot_sync(kFull, ends[u]);
            const int last = found ? __ffs(found) - 1 : 31;  // lanes 0..last hold pieces of the run
            if (!done && lane <= last) {
#pragma unroll
                for (int q = 0; q < Q; ++q) {
                    acc[4 * q + 0] += piece[u][q].x; acc[4 * q + 1] += piece[u][q].y;
                    acc[4 * q + 2] += piece[u][q].z; acc[4 * q + 3] += piece[u][q].w;
                }
            }
            done = done || found;
        }
        if (done) break;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < W; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], off);
    }
    if (lane == 0) store_row<D, F>(out + Q * (size_t)key, acc);
}

// the tile that owns row r: the last tile whose stretch starts at or before
// r (tile 0's starts at 0, tile t's at its first key), by one warp: each
// round tests 32 tiles' first keys spread over the interval left
__device__ int owner_tile(const int* __restrict__ key_s, int tiles, int r, int lane) {
    int lo = 1, hi = tiles;  // the first tile whose stretch starts past r lies in [lo, hi]
    while (hi - lo > 32) {
        const int step = (hi - lo + 31) / 32;
        const int i = lo + lane * step;
        const int c = __popc(__ballot_sync(kFull, i < hi && __ldg(key_s + (size_t)i * kTile) <= r));
        if (c == 0) {
            hi = lo;
        } else {
            hi = min(hi, lo + c * step);
            lo = lo + (c - 1) * step + 1;
        }
    }
    const int i = lo + lane;
    return lo + __popc(__ballot_sync(kFull, i < hi && __ldg(key_s + (size_t)i * kTile) <= r)) - 1;
}

// rows [w0, w0 + kFill) of out: the zeros of the long stretches in them.
// Only the tiles that own the first and the last row can own a long stretch
// here; for each, its keys are marked in shared memory and its other rows in
// the block's rows are zeroed (16 bytes a thread, coalesced)
template <int D, int F>
__device__ void fill_zeros(const int* __restrict__ key_s, float4* __restrict__ out, int n, int m, int tiles, int w0) {
    constexpr int Q = Row<D, F>::Q;
    __shared__ unsigned char hit[kFill];
    __shared__ int owner[2];
    const int t = threadIdx.x;
    const int w1 = min(w0 + kFill, m);
    if (t < 32) {
        const int a = owner_tile(key_s, tiles, w0, t);
        const int b = owner_tile(key_s, tiles, w1 - 1, t);
        if (t == 0) owner[0] = a, owner[1] = b;
    }
    __syncthreads();
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int o = 0; o < 2; ++o) {  // block-uniform control flow
        const int tile = owner[o];
        if (o == 1 && tile == owner[0]) break;
        const int base = tile * kTile;
        const int end = min(base + kTile, n);
        const int r0 = tile == 0 ? 0 : __ldg(key_s + base);
        const int r1 = end < n ? __ldg(key_s + end) : m;
        const int lo = max(w0, r0), hi = min(w1, r1);
        if (r1 - r0 <= kLong || lo >= hi) continue;  // a short stretch: its tile wrote all of it
        for (int i = t; i < hi - lo; i += kEdgeThreads) hit[i] = 0;
        __syncthreads();
        for (int s = base + t; s < end; s += kEdgeThreads) {
            const int key = __ldg(key_s + s);
            if (key >= lo && key < hi) hit[key - lo] = 1;
        }
        __syncthreads();
        float4* dst = out + Q * (size_t)lo;
        for (int i = t; i < Q * (hi - lo); i += kEdgeThreads)
            if (!hit[i / Q]) dst[i] = zero;
        __syncthreads();
    }
    asm volatile("griddepcontrol.wait;" ::: "memory");  // launch 2 ends after launch 1
}

// launch 2: blocks [0, cross_blocks) sum the runs that cross tile edges, the
// rest write the zeros of the long stretches, kFill rows each
template <int D, int F>
__global__ void __launch_bounds__(kEdgeThreads) segsum_edge_kernel(const int* __restrict__ key_s,
                                                                    const float* scratch,
                                                                    float4* __restrict__ out, int n, int m, int tiles,
                                                                    int cross_blocks) {
    if ((int)blockIdx.x < cross_blocks) cross_run<D, F>(key_s, scratch, out, n, tiles);
    else fill_zeros<D, F>(key_s, out, n, m, tiles, ((int)blockIdx.x - cross_blocks) * kFill);
}

// the tile kernel's dynamic shared memory: its closed runs where they
// outgrow the static 48 KB (the limit raised once an instance and device)
template <int D, int F, bool kVec>
int tile_smem(size_t* bytes) {
    *bytes = 0;
    if constexpr (Row<D, F>::kDynamic) {
        *bytes = sizeof(float4) * kTile * Row<D, F>::Q;
        static unsigned long long raised = 0;  // bit i: device i
        int dev = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e != cudaSuccess) return (int)e;
        if (dev >= 64 || !((raised >> dev) & 1ull)) {
            e = cudaFuncSetAttribute(segsum_tile_kernel<D, F, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)*bytes);
            if (e != cudaSuccess) return (int)e;
            if (dev < 64) raised |= 1ull << dev;
        }
    }
    return 0;
}

template <int D, int F>
int launch_segsum(const int* k, const float* w, const float* g, float4* o, float* sc, int n, int m, int vec,
                  cudaStream_t st) {
    const int tiles = (n + kTile - 1) / kTile;
    size_t smem = 0;
    int err = vec ? tile_smem<D, F, true>(&smem) : tile_smem<D, F, false>(&smem);
    if (err) return err;
    if (vec) segsum_tile_kernel<D, F, true><<<tiles, kThreads, smem, st>>>(k, w, g, o, sc, n, m);
    else segsum_tile_kernel<D, F, false><<<tiles, kThreads, smem, st>>>(k, w, g, o, sc, n, m);
    err = (int)cudaGetLastError();
    if (err) return err;
    const int cross_blocks = (int)((32LL * tiles + kEdgeThreads - 1) / kEdgeThreads);
    const int fill_blocks = (m + kFill - 1) / kFill;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(cross_blocks + fill_blocks));
    cfg.blockDim = dim3(kEdgeThreads);
    cfg.stream = st;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, segsum_edge_kernel<D, F>, k, (const float*)sc, o, n, m, tiles,
                                   cross_blocks);
}

}  // namespace

// out [m, 2^d * f] from n sorted samples, d = 2 or 3, f = 2 or 4 (dout_s
// [n, f]); scratch [ceil(n / kTile), 2, 2^d * f] f32. vec: key_s, w1_s and
// dout_s are 16-byte aligned (16-byte loads).
extern "C" int nst_segsum(const void* key_s, const void* w1_s, const void* dout_s, void* out, void* scratch, int n,
                          int m, int d, int f, int vec, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if ((d != 2 && d != 3) || (f != 2 && f != 4)) return (int)cudaErrorInvalidValue;
    if (m <= 0) return (int)cudaGetLastError();
    if (n <= 0) return (int)cudaMemsetAsync(out, 0, (size_t)m * (4 << d) * f, st);
    const int* k = (const int*)key_s;
    const float* w = (const float*)w1_s;
    const float* g = (const float*)dout_s;
    float4* o = (float4*)out;
    float* sc = (float*)scratch;
    if (f == 2) {
        return d == 3 ? launch_segsum<3, 2>(k, w, g, o, sc, n, m, vec, st)
                      : launch_segsum<2, 2>(k, w, g, o, sc, n, m, vec, st);
    }
    return d == 3 ? launch_segsum<3, 4>(k, w, g, o, sc, n, m, vec, st) : launch_segsum<2, 4>(k, w, g, o, sc, n, m, vec, st);
}
