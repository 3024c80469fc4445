// Kernel D: dynamic gathers of 4-byte elements (f32 and i32 share it).
//
// Replaces the Pallas gather kernels of the TPU build (scratch/probe_arch.py:30,
// scratch/probe_pallas.py:9/30/48, scratch/probe_gather2.py:37/57/78,
// scratch/probe_chain.py:69, scratch/probe_honest2.py:59,
// scratch/probe_dyngather_forms.py:15, scratch/probe_ax0_sweep.py:9), i.e.
// jnp.take and jnp.take_along_axis as the JAX package calls them:
//   form 0, rows:   out[q, c] = x[idx[q], c]          x [S, C], idx [Q],     out [Q, C]
//   form 1, axis 1: out[q, c] = x[q, idx[q, c]]       x [S, C], idx [S, Cq], out [S, Cq]
//   form 2, axis 0: out[q, c] = x[idx[q, c], c]       x [S, C], idx [Q, C],  out [Q, C]
// The 1-D take is form 0 with C = 1. Indices are int32 or int64 and in range
// (the callers' precondition, as at every JAX call site). A gather is a copy,
// so the result is bit-equal to torch.gather / index_select and to JAX.
//
// What bounds it on the H100: bytes (each index read once, each touched
// source element read once, each output written once, over 3.35 TB/s).
// Tensor cores and arithmetic play no part. What keeps a gather off that
// bound is the width and the order of its memory accesses: a 4-byte access
// per thread, a scattered read that touches a 32-byte sector for 4 useful
// bytes, and per-element index arithmetic.
//
// Design (v2). The wrapper (ops/gather.py::plan) picks a variant, the vector
// widths and the launch shape on the host, from the shapes and from the
// 16-byte alignment of the pointers, and passes them as one GatherPlan. The
// kernels do no per-element division: a 2-D block gives each thread its
// access within a row (threadIdx.x, one per access up to 256) and its row
// (threadIdx.y and blockIdx), so a warp covers consecutive addresses of the
// output; each thread keeps kRows rows in flight (indices first, then the
// sources, then the stores) so that enough bytes are on the way.
//   form 1, staged: a block stages a group of whole rows of x in dynamic
//     shared memory (at most 32 KB, with 16-byte loads, coalesced), then
//     each thread reads 4 int32 (or 2 int64) indices with one 16-byte load,
//     picks from shared memory and stores 16 (or 8) bytes. Its first
//     indices are read before the staging barrier. The scattered reads land
//     in shared memory, where they cost a bank access, not a 32-byte sector.
//   form 1, direct: rows wider than 48 KB, or rows read sparsely (fewer than
//     one pick per 8 elements, where staging would move more bytes than the
//     picks), read x straight from device memory, same thread layout.
//   form 0: whole rows are copied with 16-byte loads and stores when C % 4 is
//     0 and both pointers are 16-byte aligned, else 4 bytes at a time.
//   form 2: one element per thread, the same layout.
// A contiguous view with a storage offset may be 4-byte aligned only; the
// plan sends it to the 4-byte variants. Row offsets are 64-bit, in-row
// offsets 32-bit. The TPU kernels' VMEM blocking (2048-row blocks, (8, 128)
// tiles) is not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// The launch of one call, made by ops/gather.py::plan (kernels.GatherPlan
// there, field for field).
struct GatherPlan {
    long long form;  // 0 rows, 1 axis 1, 2 axis 0
    long long idx64;  // int64 indices (else int32)
    long long S, C, Q, Cq;  // x [S, C]; Q index rows of Cq indices
    long long staged;  // form 1: rows go through shared memory
    long long xvec;  // elements per access of x (4: 16-byte loads)
    long long ivec;  // form 1: indices per 16-byte load, else 1
    long long rows;  // form 1: rows per block
    long long tx, ty, blocks;  // block shape and grid
    long long smem;  // dynamic shared memory, bytes
};

namespace {

constexpr int kRows = 4;  // rows a thread has in flight (ops/gather.py ROWS_IN_FLIGHT)

// IV indices in one load, and the output vector of IV elements
template <typename Index, int IV> struct Vec;
template <typename Index> struct Vec<Index, 1> {
    using I = Index;
    using O = uint32_t;
};
template <> struct Vec<int, 4> {
    using I = int4;
    using O = uint4;
};
template <> struct Vec<long long, 2> {
    using I = longlong2;
    using O = uint2;
};

template <bool kShared>
__device__ __forceinline__ uint32_t get(const uint32_t* row, long long j) {
    if constexpr (kShared) {
        return row[j];
    } else {
        return __ldg(row + j);
    }
}

// out[g-th vector of the row] from the row's g-th index vector iv
template <bool kShared, typename Index, int IV>
__device__ __forceinline__ void pick_store(const uint32_t* src, const typename Vec<Index, IV>::I& iv, uint32_t* orow,
                                           int g) {
    typename Vec<Index, IV>::O o;
    if constexpr (IV == 4) {
        o = make_uint4(get<kShared>(src, iv.x), get<kShared>(src, iv.y), get<kShared>(src, iv.z),
                       get<kShared>(src, iv.w));
    } else if constexpr (IV == 2) {
        o = make_uint2(get<kShared>(src, iv.x), get<kShared>(src, iv.y));
    } else {
        o = get<kShared>(src, iv);
    }
    reinterpret_cast<typename Vec<Index, IV>::O*>(orow)[g] = o;
}

// the index vectors of column group g of rows r, r + ty, ... (kRows of them)
template <typename Index, int IV>
__device__ __forceinline__ void load_indices(typename Vec<Index, IV>::I (&iv)[kRows], const Index* idx, long long r0,
                                             int r, int g, int nrows, int groups, int Cq) {
    using VI = typename Vec<Index, IV>::I;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        const int rr = r + k * (int)blockDim.y;
        if (rr < nrows && g < groups) iv[k] = __ldg(reinterpret_cast<const VI*>(idx + (r0 + rr) * Cq) + g);
    }
}

// form 1. Block b covers rows [b * rows, b * rows + rows); kStaged copies
// them to shared memory first (XV = 4: 16-byte loads). The indices of a
// thread's first kRows rows are read before the staging barrier, so their
// latency hides behind the staging copy.
template <typename Index, bool kStaged, int XV, int IV>
__global__ void __launch_bounds__(256) axis1_kernel(const uint32_t* __restrict__ x, const Index* __restrict__ idx,
                                                    uint32_t* __restrict__ out, int S, int C, int Cq, int rows) {
    extern __shared__ uint4 smem[];
    uint32_t* sx = reinterpret_cast<uint32_t*>(smem);
    const long long r0 = (long long)blockIdx.x * rows;
    const int nrows = min((long long)rows, S - r0);
    const int groups = Cq / IV;  // the plan takes IV > 1 only when IV divides Cq
    typename Vec<Index, IV>::I iv[kRows];
    load_indices<Index, IV>(iv, idx, r0, threadIdx.y, threadIdx.x, nrows, groups, Cq);
    if (kStaged) {
        const int n = nrows * C;
        const int tid = threadIdx.y * blockDim.x + threadIdx.x;
        const int nthreads = blockDim.x * blockDim.y;
        if (XV == 4) {
            const uint4* xs = reinterpret_cast<const uint4*>(x + r0 * C);
#pragma unroll 4
            for (int i = tid; i < (n >> 2); i += nthreads) smem[i] = __ldg(xs + i);
        } else {
            const uint32_t* xs = x + r0 * C;
#pragma unroll 4
            for (int i = tid; i < n; i += nthreads) sx[i] = __ldg(xs + i);
        }
        __syncthreads();
    }
    for (int r = threadIdx.y; r < nrows; r += blockDim.y * kRows) {
        for (int g = threadIdx.x; g < groups; g += blockDim.x) {
            if (r != (int)threadIdx.y || g != (int)threadIdx.x) load_indices<Index, IV>(iv, idx, r0, r, g, nrows, groups, Cq);
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
                const int rr = r + k * (int)blockDim.y;
                if (rr < nrows) {
                    const uint32_t* src = kStaged ? sx + (long long)rr * C : x + (r0 + rr) * C;
                    pick_store<kStaged, Index, IV>(src, iv[k], out + (r0 + rr) * Cq, g);
                }
            }
        }
    }
}

// form 0: row q of out is row idx[q] of x, in accesses of E (V elements).
// Block b covers rows [b * ty * kRows, (b + 1) * ty * kRows); a thread
// reads its kRows indices, then its kRows sources, then stores.
template <typename Index, int V>
__global__ void __launch_bounds__(256) rows_kernel(const uint32_t* __restrict__ x, const Index* __restrict__ idx,
                                                   uint32_t* __restrict__ out, long long Q, int C) {
    using E = typename std::conditional<V == 4, uint4, uint32_t>::type;
    const int nv = C / V;
    const int ty = blockDim.y;
    const long long q0 = (long long)blockIdx.x * ty * kRows + threadIdx.y;
    const E* xe = reinterpret_cast<const E*>(x);
    E* oe = reinterpret_cast<E*>(out);
    long long src[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
        const long long q = q0 + (long long)k * ty;
        src[k] = q < Q ? (long long)__ldg(idx + q) * nv : -1;
    }
    for (int v = threadIdx.x; v < nv; v += blockDim.x) {
        E val[kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k)
            if (src[k] >= 0) val[k] = __ldg(xe + src[k] + v);
#pragma unroll
        for (int k = 0; k < kRows; ++k)
            if (src[k] >= 0) oe[(q0 + (long long)k * ty) * nv + v] = val[k];
    }
}

// form 2: out[q, c] = x[idx[q, c], c], the same block layout as form 0
template <typename Index>
__global__ void __launch_bounds__(256) axis0_kernel(const uint32_t* __restrict__ x, const Index* __restrict__ idx,
                                                    uint32_t* __restrict__ out, long long Q, int C) {
    const int ty = blockDim.y;
    const long long q0 = (long long)blockIdx.x * ty * kRows + threadIdx.y;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        long long src[kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
            const long long q = q0 + (long long)k * ty;
            src[k] = q < Q ? (long long)__ldg(idx + q * C + c) * C + c : -1;
        }
        uint32_t val[kRows];
#pragma unroll
        for (int k = 0; k < kRows; ++k)
            if (src[k] >= 0) val[k] = __ldg(x + src[k]);
#pragma unroll
        for (int k = 0; k < kRows; ++k)
            if (src[k] >= 0) out[(q0 + (long long)k * ty) * C + c] = val[k];
    }
}

template <typename Index, int IV>
void launch_axis1(const uint32_t* x, const Index* idx, uint32_t* out, int S, int C, int Cq, int staged, int xvec,
                  int rows, dim3 grid, dim3 block, int smem, cudaStream_t st) {
    if (!staged) {
        axis1_kernel<Index, false, 1, IV><<<grid, block, 0, st>>>(x, idx, out, S, C, Cq, rows);
    } else if (xvec == 4) {
        axis1_kernel<Index, true, 4, IV><<<grid, block, smem, st>>>(x, idx, out, S, C, Cq, rows);
    } else {
        axis1_kernel<Index, true, 1, IV><<<grid, block, smem, st>>>(x, idx, out, S, C, Cq, rows);
    }
}

template <typename Index, int IVmax>
int launch(const void* xp, const void* ip, void* op, const GatherPlan& p, cudaStream_t st) {
    const uint32_t* x = (const uint32_t*)xp;
    const Index* idx = (const Index*)ip;
    uint32_t* out = (uint32_t*)op;
    const int S = (int)p.S, C = (int)p.C, Cq = (int)p.Cq;
    const dim3 grid((unsigned)p.blocks), block((unsigned)p.tx, (unsigned)p.ty);
    if (p.form == 0) {
        if (p.xvec == 4) rows_kernel<Index, 4><<<grid, block, 0, st>>>(x, idx, out, p.Q, C);
        else rows_kernel<Index, 1><<<grid, block, 0, st>>>(x, idx, out, p.Q, C);
    } else if (p.form == 1) {
        const int staged = (int)p.staged, xvec = (int)p.xvec, rows = (int)p.rows, smem = (int)p.smem;
        if (p.ivec == IVmax) launch_axis1<Index, IVmax>(x, idx, out, S, C, Cq, staged, xvec, rows, grid, block, smem, st);
        else launch_axis1<Index, 1>(x, idx, out, S, C, Cq, staged, xvec, rows, grid, block, smem, st);
    } else {
        axis0_kernel<Index><<<grid, block, 0, st>>>(x, idx, out, p.Q, C);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// One launch, as the plan says.
extern "C" int nst_gather(const void* x, const void* idx, void* out, const GatherPlan* plan, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (plan->idx64) return launch<long long, 2>(x, idx, out, *plan, st);
    return launch<int, 4>(x, idx, out, *plan, st);
}
