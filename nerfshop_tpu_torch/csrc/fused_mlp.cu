// Kernel C: fused bias-free ReLU MLP forward, bf16 operands, fp32 sums.
//
// Replaces the Pallas fused MLP of scratch/probe_arch.py:52-65 (mlp_kern /
// f_mlp), which computes nerfshop_tpu/models/mlp.py:61-75 (MLP.apply):
//   h = bf16(x);  h = bf16(relu(h @ bf16(W_i)))  for each hidden layer,
//   out = h @ bf16(W_last)                        in fp32, no activation.
// Every product of two bf16 values is exact in fp32, so only the order of
// the fp32 sums differs from JAX and from the plain PyTorch version.
//
// Shapes: x [N, IN] f32 row-major with 1 <= IN <= 128, zero-padded on the
// chip to whole 16-column k-tiles (rows of whole k-tiles load by float2, the
// others by pairs of scalars: a scene with light dirs gives the rgb MLP
// 16 + 16 + 3 = 35 inputs; the Takikawa encoding at its defaults gives
// the SDF MLP 80, Frequency 72, OneBlob 48 and TriangleWave 36); hidden width 64; one or two hidden layers; out
// [N, n_out] f32 with n_out <= 16 (16 for the density MLP, 3 for the rgb
// MLP: the last layer is padded on the chip with zero columns to 8 or 16
// and only n_out columns are stored). Weights come as the fp32 master
// copies [fan_in, fan_out] row-major; rows past fan_in read as zero.
//
// What bounds it on the H100: per row the density MLP (32->64->16) does
// 2*(32*64 + 64*16) = 6 kFLOP and the rgb MLP (32->64->64->3, padded to 8)
// 13 kFLOP, against 128 B of fp32 input and 64 B or 12 B of output: about
// 32 and 95 FLOP per byte. That is under the bf16 tensor-core ridge (~295 FLOP/B), so
// with the products on tensor cores HBM traffic bounds the kernel; on fp32
// CUDA cores (ridge ~20 FLOP/B) instruction issue would.
//
// Design: the products run on tensor cores with mma.sync.m16n8k16 (bf16 in,
// fp32 accumulate). A CTA of 8 warps takes 128-row tiles (16 rows a warp)
// in a grid-stride loop, so each CTA converts the weights to bf16 into
// shared memory once (transposed, [fan_out][fan_in + 8]: the 8-element pad
// keeps the B-fragment loads free of bank conflicts). The hidden
// activations never leave registers: the m16n8 accumulator layout of two
// neighbouring n-tiles is exactly the m16k16 A-fragment layout of the next
// layer, so each hidden layer is ReLU + __floats2bfloat162_rn (round to
// nearest even, as astype(bfloat16)) + a repack in place. The input is read
// with one float2 load per fragment register (each quad of lanes reads 32
// contiguous bytes of a row). The Pallas kernel's 8192-row VMEM block is not
// carried over: a CTA holds 128 rows and many CTAs fill the card.
//
// There is no backward: the training forward, which needs gradients, runs
// the plain PyTorch version with autograd (see nerfshop_tpu_torch/models/mlp.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHidden = 64;
constexpr int kHidNT = kHidden / 8;   // n-tiles of a hidden layer
constexpr int kHidKT = kHidden / 16;  // k-tiles of a hidden layer's input
constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 16;
constexpr int kRowsPerCta = kWarps * kRowsPerWarp;
constexpr int kPad = 8;  // bf16 elements added to each shared-memory row

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<uint32_t*>(&v);
}

// ReLU that keeps NaN, as jax.nn.relu and torch.relu do
__device__ __forceinline__ float relu(float v) { return v > 0.f || v != v ? v : 0.f; }

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// W [k_valid, fan_out] f32 (global) -> Wt [n_rows][fan_in + kPad] bf16
// (shared), rows n >= fan_out and columns k >= k_valid zero
__device__ void stage_weights(const float* __restrict__ w, __nv_bfloat16* wt, int fan_in, int fan_out, int n_rows,
                              int k_valid) {
    const int stride = fan_in + kPad;
    for (int i = threadIdx.x; i < n_rows * fan_in; i += blockDim.x) {
        const int n = i / fan_in, k = i % fan_in;
        const float v = n < fan_out && k < k_valid ? __ldg(w + (size_t)k * fan_out + n) : 0.f;
        wt[n * stride + k] = __float2bfloat16_rn(v);
    }
}

// x[r, c] and x[r, c + 1] of rows n_in wide; 0 past the row's end and for a
// row past the last (ok false)
__device__ __forceinline__ float2 load_pair(const float* __restrict__ x, bool ok, int r, int c, int n_in) {
    const float* row = x + (size_t)r * n_in;
    return make_float2(ok && c < n_in ? __ldg(row + c) : 0.f, ok && c + 1 < n_in ? __ldg(row + c + 1) : 0.f);
}

// acc[NT] (+)= a[KT] @ Wt over KT k-tiles; Wt row stride = KT*16 + kPad
template <int KT, int NT>
__device__ __forceinline__ void layer(float (&acc)[NT][4], const uint32_t (&a)[KT][4], const __nv_bfloat16* wt, int g, int t) {
    constexpr int stride = KT * 16 + kPad;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    }
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            const __nv_bfloat16* row = wt + (nt * 8 + g) * stride + kt * 16 + 2 * t;
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(row);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(row + 8);
            mma_bf16(acc[nt], a[kt], b0, b1);
        }
    }
}

// hidden accumulators (16 x 64 fp32) -> next layer's A fragments (bf16(relu))
__device__ __forceinline__ void to_fragments(const float (&acc)[kHidNT][4], uint32_t (&a)[kHidKT][4]) {
#pragma unroll
    for (int kt = 0; kt < kHidKT; ++kt) {
        const float* lo = acc[2 * kt];
        const float* hi = acc[2 * kt + 1];
        a[kt][0] = pack_bf16(relu(lo[0]), relu(lo[1]));
        a[kt][1] = pack_bf16(relu(lo[2]), relu(lo[3]));
        a[kt][2] = pack_bf16(relu(hi[0]), relu(hi[1]));
        a[kt][3] = pack_bf16(relu(hi[2]), relu(hi[3]));
    }
}

// WHOLE: n_in == IN_KT * 16, rows of whole k-tiles, loaded by float2
template <int IN_KT, int N_HIDDEN, int OUT_NT, bool WHOLE>
__global__ void __launch_bounds__(kWarps * 32)
fused_mlp_kernel(const float* __restrict__ x, const float* __restrict__ w_in, const float* __restrict__ w_hid,
                 const float* __restrict__ w_out, float* __restrict__ out, int n, int n_in, int n_out) {
    constexpr int kIn = IN_KT * 16;
    constexpr int kSizeIn = kHidden * (kIn + kPad);
    constexpr int kSizeHid = kHidden * (kHidden + kPad);
    constexpr int kSizeOut = OUT_NT * 8 * (kHidden + kPad);
    __shared__ __align__(16) __nv_bfloat16 smem[kSizeIn + (N_HIDDEN - 1) * kSizeHid + kSizeOut];
    __nv_bfloat16* wt_in = smem;
    __nv_bfloat16* wt_hid = smem + kSizeIn;
    __nv_bfloat16* wt_out = smem + kSizeIn + (N_HIDDEN - 1) * kSizeHid;
    stage_weights(w_in, wt_in, kIn, kHidden, kHidden, n_in);
    if (N_HIDDEN == 2) stage_weights(w_hid, wt_hid, kHidden, kHidden, kHidden, kHidden);
    stage_weights(w_out, wt_out, kHidden, n_out, OUT_NT * 8, kHidden);
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;  // mma group id / thread in group
    const int n_tiles = (n + kRowsPerCta - 1) / kRowsPerCta;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int r0 = tile * kRowsPerCta + warp * kRowsPerWarp + g;  // rows r0 and r0 + 8
        const int r1 = r0 + 8;
        const bool ok0 = r0 < n, ok1 = r1 < n;

        uint32_t a_in[IN_KT][4];
#pragma unroll
        for (int kt = 0; kt < IN_KT; ++kt) {
            const int c = kt * 16 + 2 * t;
            const float2 z = make_float2(0.f, 0.f);
            float2 x00, x10, x01, x11;
            if (WHOLE) {
                x00 = ok0 ? __ldg(reinterpret_cast<const float2*>(x + (size_t)r0 * kIn + c)) : z;
                x10 = ok1 ? __ldg(reinterpret_cast<const float2*>(x + (size_t)r1 * kIn + c)) : z;
                x01 = ok0 ? __ldg(reinterpret_cast<const float2*>(x + (size_t)r0 * kIn + c + 8)) : z;
                x11 = ok1 ? __ldg(reinterpret_cast<const float2*>(x + (size_t)r1 * kIn + c + 8)) : z;
            } else {
                x00 = load_pair(x, ok0, r0, c, n_in);
                x10 = load_pair(x, ok1, r1, c, n_in);
                x01 = load_pair(x, ok0, r0, c + 8, n_in);
                x11 = load_pair(x, ok1, r1, c + 8, n_in);
            }
            a_in[kt][0] = pack_bf16(x00.x, x00.y);
            a_in[kt][1] = pack_bf16(x10.x, x10.y);
            a_in[kt][2] = pack_bf16(x01.x, x01.y);
            a_in[kt][3] = pack_bf16(x11.x, x11.y);
        }

        float acc[kHidNT][4];
        uint32_t a_hid[kHidKT][4];
        layer<IN_KT, kHidNT>(acc, a_in, wt_in, g, t);
        to_fragments(acc, a_hid);
        if (N_HIDDEN == 2) {
            layer<kHidKT, kHidNT>(acc, a_hid, wt_hid, g, t);
            to_fragments(acc, a_hid);
        }
        float acc_out[OUT_NT][4];
        layer<kHidKT, OUT_NT>(acc_out, a_hid, wt_out, g, t);

#pragma unroll
        for (int nt = 0; nt < OUT_NT; ++nt) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int c = nt * 8 + 2 * t + j;
                if (c < n_out) {
                    if (ok0) out[(size_t)r0 * n_out + c] = acc_out[nt][j];
                    if (ok1) out[(size_t)r1 * n_out + c] = acc_out[nt][2 + j];
                }
            }
        }
    }
}

template <int IN_KT, int N_HIDDEN, int OUT_NT, bool WHOLE>
int launch(const float* x, const float* w_in, const float* w_hid, const float* w_out, float* out, int n, int n_in,
           int n_out, cudaStream_t stream) {
    auto kernel = fused_mlp_kernel<IN_KT, N_HIDDEN, OUT_NT, WHOLE>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, 0);
    const int n_tiles = (n + kRowsPerCta - 1) / kRowsPerCta;
    int blocks = sms * (per_sm > 0 ? per_sm : 1);
    if (blocks > n_tiles) blocks = n_tiles;
    kernel<<<blocks, kWarps * 32, 0, stream>>>(x, w_in, w_hid, w_out, out, n, n_in, n_out);
    return (int)cudaGetLastError();
}

template <int IN_KT, int N_HIDDEN, bool WHOLE>
int launch_out(const float* x, const float* w_in, const float* w_hid, const float* w_out, float* out, int n,
               int n_in, int n_out, cudaStream_t stream) {
    if (n_out <= 8) return launch<IN_KT, N_HIDDEN, 1, WHOLE>(x, w_in, w_hid, w_out, out, n, n_in, n_out, stream);
    return launch<IN_KT, N_HIDDEN, 2, WHOLE>(x, w_in, w_hid, w_out, out, n, n_in, n_out, stream);
}

template <int IN_KT, bool WHOLE>
int launch_hidden(const float* x, const float* w_in, const float* w_hid, const float* w_out, float* out, int n,
                  int n_in, int n_hidden, int n_out, cudaStream_t stream) {
    if (n_hidden == 1) return launch_out<IN_KT, 1, WHOLE>(x, w_in, w_hid, w_out, out, n, n_in, n_out, stream);
    return launch_out<IN_KT, 2, WHOLE>(x, w_in, w_hid, w_out, out, n, n_in, n_out, stream);
}

template <int IN_KT>
int launch_in(const float* x, const float* w_in, const float* w_hid, const float* w_out, float* out, int n,
              int n_in, int n_hidden, int n_out, cudaStream_t stream) {
    if (n_in == IN_KT * 16) return launch_hidden<IN_KT, true>(x, w_in, w_hid, w_out, out, n, n_in, n_hidden, n_out, stream);
    return launch_hidden<IN_KT, false>(x, w_in, w_hid, w_out, out, n, n_in, n_hidden, n_out, stream);
}

}  // namespace

// x [n, n_in] f32, w_in [n_in, 64], w_hid [64, 64] (n_hidden == 2, else
// unused), w_out [64, n_out], out [n, n_out] f32. 1 <= n_in <= 128,
// n_hidden in {1, 2}, 1 <= n_out <= 16; anything else returns
// cudaErrorInvalidValue without launching.
extern "C" int nst_fused_mlp(const void* x, const void* w_in, const void* w_hid, const void* w_out, void* out, int n,
                             int n_in, int n_hidden, int n_out, void* stream) {
    if (n_in < 1 || n_in > 128 || n_hidden < 1 || n_hidden > 2 || n_out < 1 || n_out > 16 || n < 0) {
        return (int)cudaErrorInvalidValue;
    }
    if (n == 0) return (int)cudaGetLastError();
    const float *px = (const float*)x, *pi = (const float*)w_in, *ph = (const float*)w_hid, *po = (const float*)w_out;
    float* py = (float*)out;
    cudaStream_t s = (cudaStream_t)stream;
    switch ((n_in + 15) / 16) {
        case 1: return launch_in<1>(px, pi, ph, po, py, n, n_in, n_hidden, n_out, s);
        case 2: return launch_in<2>(px, pi, ph, po, py, n, n_in, n_hidden, n_out, s);
        case 3: return launch_in<3>(px, pi, ph, po, py, n, n_in, n_hidden, n_out, s);
        case 4: return launch_in<4>(px, pi, ph, po, py, n, n_in, n_hidden, n_out, s);
        case 5: return launch_in<5>(px, pi, ph, po, py, n, n_in, n_hidden, n_out, s);
        case 6: return launch_in<6>(px, pi, ph, po, py, n, n_in, n_hidden, n_out, s);
        case 7: return launch_in<7>(px, pi, ph, po, py, n, n_in, n_hidden, n_out, s);
        default: return launch_in<8>(px, pi, ph, po, py, n, n_in, n_hidden, n_out, s);
    }
}
