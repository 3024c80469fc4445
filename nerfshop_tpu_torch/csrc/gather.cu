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
// What bounds it on the H100: bytes. Each output element costs one index
// read, one 4-byte read of x (scattered, but x mostly sits in the 50 MB L2 at
// the path's shapes) and one 4-byte write.
//
// Design: one thread per output element in a grid-stride loop, outputs and
// indices in memory order, so index reads and output writes are coalesced;
// the x reads go through the read-only cache. Offsets are 32-bit whenever x
// and the output both have fewer than 2^31 − 2^23 elements (every call site of the
// system), since 64-bit division and multiplication cost several times the
// instructions. The TPU kernels' VMEM blocking (2048-row blocks, (8, 128)
// tiles) is not carried over; shared-memory or TMA staging of x is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename Index, typename Off>
__global__ void gather_kernel(const uint32_t* __restrict__ x, const Index* __restrict__ idx,
                              uint32_t* __restrict__ out, Off n_out, Off C, Off C_out, int form) {
    const Off stride = (Off)gridDim.x * blockDim.x;
    for (Off e = (Off)blockIdx.x * blockDim.x + threadIdx.x; e < n_out; e += stride) {
        const Off q = e / C_out;
        const Off c = e - q * C_out;
        Off src;
        if (form == 0) {
            src = (Off)__ldg(idx + q) * C + c;
        } else if (form == 1) {
            src = q * C + (Off)__ldg(idx + e);
        } else {
            src = (Off)__ldg(idx + e) * C + c;
        }
        out[e] = __ldg(x + src);
    }
}

template <typename Index>
void launch(const void* x, const void* idx, void* out, long long n_out, long long n_x, int C, int C_out, int form,
            cudaStream_t st) {
    const int threads = 256;
    const long long want = (n_out + threads - 1) / threads;
    const int blocks = (int)(want < 132LL * 64 ? want : 132LL * 64);
    const long long lim = (1LL << 31) - (1LL << 23);  // e + stride stays below 2^31
    if (n_out < lim && n_x < lim) {
        gather_kernel<Index, int><<<blocks, threads, 0, st>>>(
            (const uint32_t*)x, (const Index*)idx, (uint32_t*)out, (int)n_out, C, C_out, form);
    } else {
        gather_kernel<Index, long long><<<blocks, threads, 0, st>>>(
            (const uint32_t*)x, (const Index*)idx, (uint32_t*)out, n_out, (long long)C, (long long)C_out, form);
    }
}

}  // namespace

extern "C" int nst_gather(const void* x, const void* idx, void* out, long long n_out, long long n_x, int C,
                          int C_out, int form, int idx64, void* stream) {
    if (n_out <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    if (idx64) {
        launch<long long>(x, idx, out, n_out, n_x, C, C_out, form, st);
    } else {
        launch<int>(x, idx, out, n_out, n_x, C, C_out, form, st);
    }
    return (int)cudaGetLastError();
}
