// Kernels H and I: the shear-warp frame of the baked interactive preview.
//
// Replace the XLA-fused frame of nerfshop_tpu/render/baked.py::_frame_impl
// (not Pallas kernels):
//   H, nst_shear_composite: the per-slice separable resample (:492-547, two
//     row gathers and lerps) and the front-to-back composite (:551-564) →
//     the base raster [Bi (x'), Bi (y'), 5] f32 (rgb, 1 - T, depth);
//   I, nst_shear_screen: each pixel's ray (render_baked :649-674) meets the
//     base plane, the raster is sampled bilinearly there (:566-600) and the
//     sky blended in → rgba [H, W, 4] f32 and depth [H, W] f32.
// Inputs: one layout of the bake, [B (k), B (y), B (x), 4] bf16 (rgb, sigma),
// and struct FrameArgs below, which render/baked.py::frame_params computes on
// the host (no tensor, so no device read before a frame).
//
// Arithmetic: the plain versions' (render/baked.py), operation for
// operation: every coordinate is computed with explicitly rounded
// intrinsics, so that nvcc contracts no multiply-add the plain version
// rounds twice, and every lerp is a·(1 - f) + b·f. Interpolation is in f32
// from the bf16 taps (JAX rounds the fractions and each lerp to bf16). The
// weight of a slice is exp(-(sum tau before it)) · (1 - exp(-tau)), written
// as JAX writes it, exp(-(ctau - tau)) with ctau the running sum including
// the slice. A slice behind the eye or off the volume contributes exactly
// 0 in the plain version (tau = 0), so H skips it without a load.
//
// What bounds them on the H100: bytes. H must read the layout once (B^3 · 8
// bytes, 134 MB at B = 256) and write the raster; I reads the raster and
// writes the frame (33.2 MB rgba + 8.3 MB depth at 1080p).
//
// Design (a simple first version):
// - H: one thread per base texel, blocks of 64 (x') × 4 (y'), looping over
//   the B slices. Neighbouring threads hold neighbouring x', whose source x
//   in a slice are neighbours too, so a warp's four 8-byte taps of a slice
//   coalesce along the layout's contiguous axis. Each texel reads its own
//   taps (up to 4 · B of them, L1 and L2 hits for the most part): far from
//   the bound. Staging slabs of slices in shared memory is later work.
// - I: one thread per pixel; the raster (2.9 MB at Bi = 384) stays in L2.

#include <cuda_runtime.h>
#include <stdint.h>

struct FrameArgs {
    float e[3];  // eye (k, y, x) in index space of the layout, after the flip
    float box[4];  // base raster extent on the plane k = 0.5: by0, by1, bx0, bx1
    float cell_world;  // world length of one cell (a cubic box)
    float rows[9];  // camera-to-world rows of the world axes (k, y, x)
    float scale[3];  // world → index scale of (k, y, x), k negated on a flip
    float focal[2];
    float principal_px[2];  // principal point · (W, H)
    float sky[4];
    int B, Bi, W, H, flip, with_depth;
};

namespace {

constexpr int kTileX = 64;
constexpr int kTileY = 4;
constexpr int kScreenThreads = 256;

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
    return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f));
}

// four bf16 channels (8 bytes) → f32; the bits of a bf16 are the high half of an f32's
__device__ __forceinline__ void tap(const uint2* __restrict__ field, long long idx, float v[4]) {
    const uint2 u = __ldg(field + idx);
    v[0] = __uint_as_float(u.x << 16);
    v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16);
    v[3] = __uint_as_float(u.y & 0xffff0000u);
}

struct Src {
    int q0;  // clamped to [0, B - 2]
    float frac;  // from the unclamped floor
    bool valid;
};

// the source coordinate in a slice of a base coordinate: q = e + (base - e) / s, less half a cell
__device__ __forceinline__ Src source(float base, float e, float inv_s, int B) {
    const float s = __fsub_rn(__fadd_rn(__fmul_rn(__fsub_rn(base, e), inv_s), e), 0.5f);
    const float q = floorf(s);
    Src r;
    r.frac = __fsub_rn(s, q);
    r.q0 = (int)fminf(fmaxf(q, 0.0f), (float)(B - 2));
    r.valid = s >= 0.0f && s <= (float)(B - 1);
    return r;
}

// base[i] = b0 + (i + 0.5) · (b1 - b0) / Bi
__device__ __forceinline__ float base_coord(int i, float b0, float b1, int Bi) {
    return __fadd_rn(b0, __fdiv_rn(__fmul_rn((float)i + 0.5f, __fsub_rn(b1, b0)), (float)Bi));
}

__global__ void __launch_bounds__(kTileX * kTileY)
composite_kernel(const FrameArgs a, const uint2* __restrict__ field, float* __restrict__ raster) {
    const int i = blockIdx.x * kTileX + threadIdx.x;  // x'
    const int j = blockIdx.y * kTileY + threadIdx.y;  // y'
    const int B = a.B, Bi = a.Bi;
    if (i >= Bi || j >= Bi) return;
    const float ez = a.e[0], ey = a.e[1], ex = a.e[2];
    const float base_y = base_coord(j, a.box[0], a.box[1], Bi);
    const float base_x = base_coord(i, a.box[2], a.box[3], Bi);
    const float dz0 = __fsub_rn(0.5f, ez);
    const float dby = __fsub_rn(base_y, ey), dbx = __fsub_rn(base_x, ex);
    // the ray's obliquity: path length per slice = cell_world · sec
    const float sec = __fdiv_rn(
        __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(dby, dby), __fmul_rn(dbx, dbx)), __fmul_rn(dz0, dz0))), fabsf(dz0));
    const float dt = __fmul_rn(a.cell_world, sec);
    float ctau = 0.0f, acc[3] = {0.0f, 0.0f, 0.0f}, depth = 0.0f;
    for (int k = 0; k < B; ++k) {
        const float rel = __fsub_rn((float)k + 0.5f, ez);
        if (!(rel > 1e-3f)) continue;  // behind the eye
        float s = __fdiv_rn(dz0, rel);
        if (fabsf(s) < 1e-6f) s = 1e-6f;
        const float inv_s = __fdiv_rn(1.0f, s);
        const Src sy = source(base_y, ey, inv_s, B);
        const Src sx = source(base_x, ex, inv_s, B);
        if (!(sy.valid && sx.valid)) continue;  // off the slice
        const int ks = a.flip ? B - 1 - k : k;
        const long long r0 = ((long long)ks * B + sy.q0) * B + sx.q0;
        float t00[4], t01[4], t10[4], t11[4];  // t[y][x]
        tap(field, r0, t00);
        tap(field, r0 + 1, t01);
        tap(field, r0 + B, t10);
        tap(field, r0 + B + 1, t11);
        float v[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
            v[c] = lerp_rn(lerp_rn(t00[c], t10[c], sy.frac), lerp_rn(t01[c], t11[c], sy.frac), sx.frac);
        const float tau = __fmul_rn(fmaxf(v[3], 0.0f), dt);
        const float c_new = __fadd_rn(ctau, tau);
        const float w = __fmul_rn(expf(-__fsub_rn(c_new, tau)), __fsub_rn(1.0f, expf(-tau)));
        ctau = c_new;
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(w, v[c]));
        if (a.with_depth) depth = __fadd_rn(depth, __fmul_rn(w, __fmul_rn(__fmul_rn(rel, sec), a.cell_world)));
    }
    float* o = raster + ((long long)i * Bi + j) * 5;
    o[0] = acc[0];
    o[1] = acc[1];
    o[2] = acc[2];
    o[3] = __fsub_rn(1.0f, expf(-ctau));
    o[4] = depth;
}

__global__ void __launch_bounds__(kScreenThreads)
screen_kernel(const FrameArgs a, const float* __restrict__ raster, float4* __restrict__ rgba,
              float* __restrict__ depth_out) {
    const long long p = (long long)blockIdx.x * kScreenThreads + threadIdx.x;
    if (p >= (long long)a.W * a.H) return;
    const int h = (int)(p / a.W), w = (int)(p - (long long)h * a.W);
    const int Bi = a.Bi;
    const float uu = __fdiv_rn(__fsub_rn((float)w + 0.5f, a.principal_px[0]), a.focal[0]);
    const float vv = __fdiv_rn(__fsub_rn((float)h + 0.5f, a.principal_px[1]), a.focal[1]);
    float d[3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
        d[r] = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(a.rows[3 * r], uu), __fmul_rn(a.rows[3 * r + 1], vv)),
                                   a.rows[3 * r + 2]),
                         a.scale[r]);
    const float dk = fabsf(d[0]) < 1e-6f ? 1e-6f : d[0];
    const float t_hit = __fdiv_rn(__fsub_rn(0.5f, a.e[0]), dk);
    const float hy = __fadd_rn(a.e[1], __fmul_rn(t_hit, d[1]));
    const float hx = __fadd_rn(a.e[2], __fmul_rn(t_hit, d[2]));
    const float gy = __fsub_rn(__fmul_rn(__fdiv_rn(__fsub_rn(hy, a.box[0]), __fsub_rn(a.box[1], a.box[0])), (float)Bi), 0.5f);
    const float gx = __fsub_rn(__fmul_rn(__fdiv_rn(__fsub_rn(hx, a.box[2]), __fsub_rn(a.box[3], a.box[2])), (float)Bi), 0.5f);
    const bool ok = t_hit > 0.0f && gy > -1.0f && gy < (float)Bi && gx > -1.0f && gx < (float)Bi;
    const float y0 = fminf(fmaxf(floorf(gy), 0.0f), (float)(Bi - 2));
    const float x0 = fminf(fmaxf(floorf(gx), 0.0f), (float)(Bi - 2));
    const float fy = fminf(fmaxf(__fsub_rn(gy, y0), 0.0f), 1.0f);
    const float fx = fminf(fmaxf(__fsub_rn(gx, x0), 0.0f), 1.0f);
    const float* b00 = raster + ((long long)x0 * Bi + (long long)y0) * 5;  // raster[x0][y0]
    const float* b10 = b00 + (long long)Bi * 5;  // raster[x0 + 1][y0]
    float out[5];
#pragma unroll
    for (int c = 0; c < 5; ++c)
        out[c] = lerp_rn(lerp_rn(__ldg(b00 + c), __ldg(b00 + 5 + c), fy), lerp_rn(__ldg(b10 + c), __ldg(b10 + 5 + c), fy), fx);
    const float alpha = ok ? out[3] : 0.0f;
    const float t = __fsub_rn(1.0f, alpha);
    float4 o;
    o.x = __fadd_rn(ok ? out[0] : 0.0f, __fmul_rn(t, a.sky[0]));
    o.y = __fadd_rn(ok ? out[1] : 0.0f, __fmul_rn(t, a.sky[1]));
    o.z = __fadd_rn(ok ? out[2] : 0.0f, __fmul_rn(t, a.sky[2]));
    o.w = __fadd_rn(alpha, __fmul_rn(t, a.sky[3]));
    rgba[p] = o;
    depth_out[p] = ok ? __fdiv_rn(out[4], fmaxf(out[3], 1e-6f)) : 0.0f;
}

}  // namespace

extern "C" int nst_shear_composite(const FrameArgs* args, const void* field, void* raster, void* stream) {
    if (args == nullptr || args->B < 2 || args->Bi < 2) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((args->Bi + kTileX - 1) / kTileX), (unsigned)((args->Bi + kTileY - 1) / kTileY));
    composite_kernel<<<grid, dim3(kTileX, kTileY), 0, (cudaStream_t)stream>>>(*args, (const uint2*)field, (float*)raster);
    return (int)cudaGetLastError();
}

extern "C" int nst_shear_screen(const FrameArgs* args, const void* raster, void* rgba, void* depth, void* stream) {
    if (args == nullptr || args->Bi < 2 || args->W < 0 || args->H < 0) return (int)cudaErrorInvalidValue;
    const long long n = (long long)args->W * args->H;
    if (n == 0) return (int)cudaGetLastError();
    const unsigned blocks = (unsigned)((n + kScreenThreads - 1) / kScreenThreads);
    screen_kernel<<<blocks, kScreenThreads, 0, (cudaStream_t)stream>>>(*args, (const float*)raster, (float4*)rgba,
                                                                         (float*)depth);
    return (int)cudaGetLastError();
}
