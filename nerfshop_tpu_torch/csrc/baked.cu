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
// What bounds them on the H100: H must read the layout once (B^3 · 8 bytes,
// 134 MB at B = 256) and write the raster; I reads the raster and writes
// the frame (33.2 MB rgba + 8.3 MB depth at 1080p). Both are byte-bound on
// paper. H is not in practice: a base texel is about one cell of a slice
// wide, so each of its B · Bi^2 texel-slices (37.7 M at the preview's B =
// 256, Bi = 384, 72% of them on the volume) interpolates four taps and
// composites them, ~100 instructions whose order the plain version fixes,
// against 8 bytes of the layout. H's time is issue, not bytes.
//
// H's design:
// - A block is a tile of kTileX (x') × kTileY (y') texels, a thread each:
//   1152 blocks of 128 threads at Bi = 384, ~9 on each of 132 SMs, all
//   resident at once.
// - Set-up, once per block: each thread takes a run of slices and computes
//   their terms rel and 1 / s (two divisions a slice, not a texel-slice)
//   into shared memory, and
//   the tile's footprint in each: a texel's source coordinate is monotone in
//   its base coordinate (every rounded step is), so the taps of the tile's
//   texels lie between those of its first and last texel on each axis,
//   whichever the sign of 1 / s (an eye beyond the base plane mirrors it).
//   A slice behind the eye, or whose edge sources miss [0, B - 1] on an
//   axis, has no texel that meets it and is dropped; the others go, front to
//   back, into a list (a block-wide scan). render/baked.py::composite_plan
//   mirrors this set-up on the host.
// - The loop over the list, one barrier a slice: a footprint of at most
//   kBoxRows × kTileX cells is staged: its box buffer is copied with cp.async
//   (a thread a 16-byte pair of cells) kStages - 1 slices ahead. The lanes
//   of a tile row y-lerp one footprint column each from the buffer (the
//   separable resample's first pass, shared by the row's texels), and each
//   texel x-lerps two of them. A larger footprint (close views: a texel
//   over a cell wide at the back) is read directly, four taps a texel. The
//   choice is the block's, so no warp diverges on it. Both halves pay on an
//   H100: sharing the y-lerps of global loads, or staging four taps a texel
//   without sharing them, was slower; more slices a barrier changed
//   nothing. The copies are cp.async, not TMA.
// - Either way a texel's arithmetic, and its order over k, are the plain
//   version's; a staged y-lerp is the value the texel's own taps would give,
//   computed once, so both paths give the same bits.
// - The tile's raster rows are staged in shared memory and written as runs
//   of kTileY · 5 floats of the [x', y', 5] layout.
// - I: one thread per pixel; the raster (2.9 MB at Bi = 384) stays in L2.

#include <cuda_pipeline.h>
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

constexpr int kTileX = 16;  // a half-warp: its texels' taps of a slice row are neighbouring cells
constexpr int kTileY = 8;
constexpr int kThreads = kTileX * kTileY;  // a texel each
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;  // box buffers: the slice composited and the next three in flight
// a box buffer: kBoxRows rows of kBoxCols cells, copied as 16-byte pairs of cells from an even column, a thread a
// pair; it holds a footprint of up to kBoxRows × kTileX cells (the preview's far views need 9 × 16)
constexpr int kBoxRows = 10;
constexpr int kBoxCols = kTileX + 2;
constexpr int kBoxPairs = kBoxCols / 2;
constexpr int kBoxCells = kBoxRows * kBoxCols;
constexpr int kLerpBytes = kTileY * kTileX * 16;  // the y-lerped footprint columns of the tile's rows, float4 each
constexpr int kMaxB = 1024;  // a cell's index in the layout fits 31 bits
constexpr int kOutPitch = kTileY * 5 + 1;  // floats of a staged raster row (odd: fewer bank conflicts)
constexpr int kScreenThreads = 256;
constexpr int kStagedBit = 1 << 30;  // of a list entry's w
static_assert(kBoxRows * kBoxPairs <= kThreads, "a thread copies at most one pair of cells a slice");
static_assert((kStages & (kStages - 1)) == 0, "a buffer's index is a mask");
static_assert(kTileX * kOutPitch * 4 <= kStages * kBoxCells * 8, "the raster rows reuse the box buffers");

// shared memory a block: the box buffers, the y-lerps, the scan's sums, then [B] list entries and [B] terms
constexpr size_t kFixedSmem = kStages * kBoxCells * 8 + kLerpBytes + kWarps * 4;
static_assert(kFixedSmem % 16 == 0, "the list entries are 16-byte aligned");
constexpr size_t composite_smem(int B) { return kFixedSmem + (size_t)B * 24; }

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
    return __fadd_rn(__fmul_rn(a, __fsub_rn(1.0f, f)), __fmul_rn(b, f));
}

// four bf16 channels (8 bytes) → f32; the bits of a bf16 are the high half of an f32's
__device__ __forceinline__ void unpack(const uint2 u, float v[4]) {
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
__device__ __forceinline__ float source_coord(float base, float e, float inv_s) {
    return __fsub_rn(__fadd_rn(__fmul_rn(__fsub_rn(base, e), inv_s), e), 0.5f);
}

__device__ __forceinline__ int clamped_floor(float s, int B) {
    return (int)fminf(fmaxf(floorf(s), 0.0f), (float)(B - 2));
}

__device__ __forceinline__ Src source(float base, float e, float inv_s, int B) {
    const float s = source_coord(base, e, inv_s);
    Src r;
    r.frac = __fsub_rn(s, floorf(s));
    r.q0 = clamped_floor(s, B);
    r.valid = s >= 0.0f && s <= (float)(B - 1);
    return r;
}

// base[i] = b0 + (i + 0.5) · (b1 - b0) / Bi
__device__ __forceinline__ float base_coord(int i, float b0, float b1, int Bi) {
    return __fadd_rn(b0, __fdiv_rn(__fmul_rn((float)i + 0.5f, __fsub_rn(b1, b0)), (float)Bi));
}

// slice k's terms: rel (its distance from the eye in slices) and 1 / s; false behind the eye
__device__ __forceinline__ bool slice_terms(int k, float ez, float dz0, float& rel, float& inv_s) {
    rel = __fsub_rn((float)k + 0.5f, ez);
    if (!(rel > 1e-3f)) return false;
    float s = __fdiv_rn(dz0, rel);
    if (fabsf(s) < 1e-6f) s = 1e-6f;
    inv_s = __fdiv_rn(1.0f, s);
    return true;
}

// the base coordinates of a tile's first and last texel on each axis
struct TileEdges {
    float y0, y1, x0, x1;
};

// The footprint of the tile's taps in a slice: rows from y_lo, columns from x_lo. 0: no texel meets the slice;
// 1: staged (it fits a box buffer; B even and at least kBoxCols, so that a pair of cells from an even column is
// 16-byte aligned and the buffer fits the layout); 2: read directly.
__device__ __forceinline__ int slice_box(const TileEdges& t, float ey, float ex, float inv_s, int B, int& y_lo,
                                         int& x_lo) {
    const float sy0 = source_coord(t.y0, ey, inv_s), sy1 = source_coord(t.y1, ey, inv_s);
    const float sx0 = source_coord(t.x0, ex, inv_s), sx1 = source_coord(t.x1, ex, inv_s);
    const float top = (float)(B - 1);
    if (!(fmaxf(sy0, sy1) >= 0.0f && fminf(sy0, sy1) <= top && fmaxf(sx0, sx1) >= 0.0f && fminf(sx0, sx1) <= top))
        return 0;
    const int qy0 = clamped_floor(sy0, B), qy1 = clamped_floor(sy1, B);
    const int qx0 = clamped_floor(sx0, B), qx1 = clamped_floor(sx1, B);
    y_lo = min(qy0, qy1);
    x_lo = min(qx0, qx1);
    const int wy = max(qy0, qy1) + 2 - y_lo, wx = max(qx0, qx1) + 2 - x_lo;
    return (B & 1) == 0 && B >= kBoxCols && wy <= kBoxRows && wx <= kTileX ? 1 : 2;
}

// A list entry: x = k; for a staged slice y = the layout cell at its box buffer's origin, z = that origin's row,
// w = x_lo | (x_lo - the origin's column) << 16 | kStagedBit; for a direct one w = x_lo.
__global__ void __launch_bounds__(kThreads)
composite_kernel(const FrameArgs a, const uint2* __restrict__ field, float* __restrict__ raster,
                 int* __restrict__ paths) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint2* const boxes = reinterpret_cast<uint2*>(smem);  // [kStages][kBoxRows][kBoxCols] cells
    float4* const lerps = reinterpret_cast<float4*>(smem + kStages * kBoxCells * 8);  // [kTileY][kTileX]
    int* const warp_sums = reinterpret_cast<int*>(smem + kStages * kBoxCells * 8 + kLerpBytes);  // [kWarps]
    int4* const list = reinterpret_cast<int4*>(smem + kFixedSmem);  // the slices the tile meets, front to back
    float2* const terms = reinterpret_cast<float2*>(list + a.B);  // [B]: rel, 1 / s

    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int B = a.B, Bi = a.Bi;
    const int i0 = blockIdx.x * kTileX, j0 = blockIdx.y * kTileY;
    const int il = t % kTileX, jl = t / kTileX;  // a half-warp a row of the tile
    const int i = i0 + il, j = j0 + jl;  // x', y'
    const float ez = a.e[0], ey = a.e[1], ex = a.e[2];
    const float dz0 = __fsub_rn(0.5f, ez);

    // 1. set-up: this thread's run of slices [k0, k1), their terms, and how many the tile meets
    const TileEdges edges{base_coord(j0, a.box[0], a.box[1], Bi), base_coord(min(j0 + kTileY, Bi) - 1, a.box[0], a.box[1], Bi),
                          base_coord(i0, a.box[2], a.box[3], Bi), base_coord(min(i0 + kTileX, Bi) - 1, a.box[2], a.box[3], Bi)};
    const int per = (B + kThreads - 1) / kThreads;
    const int k0 = min(t * per, B), k1 = min(k0 + per, B);
    int mine = 0;
    for (int k = k0; k < k1; ++k) {
        float rel, inv_s = 0.0f;
        int y_lo, x_lo;
        if (slice_terms(k, ez, dz0, rel, inv_s) && slice_box(edges, ey, ex, inv_s, B, y_lo, x_lo) != 0) ++mine;
        terms[k] = make_float2(rel, inv_s);
    }
    int incl = mine;  // inclusive scan over the block, by warps
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int n = incl - mine, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        if (w < warp) n += warp_sums[w];
        total += warp_sums[w];
    }
    for (int k = k0; k < k1; ++k) {
        const float2 sl = terms[k];
        int y_lo, x_lo;
        if (!(sl.x > 1e-3f)) continue;
        const int mode = slice_box(edges, ey, ex, sl.y, B, y_lo, x_lo);
        if (mode == 1) {  // the buffer's origin: the footprint's, moved back to an even column inside the layout
            const int y0 = min(y_lo, B - kBoxRows), x0 = min(x_lo & ~1, B - kBoxCols);
            list[n++] = make_int4(k, ((a.flip ? B - 1 - k : k) * B + y0) * B + x0, y0, x_lo | (x_lo - x0) << 16 | kStagedBit);
        } else if (mode == 2) {
            list[n++] = make_int4(k, 0, 0, x_lo);
        }
    }
    __syncthreads();
    if (paths != nullptr && t == 0) {  // tile-slices skipped, staged, direct
        int staged = 0;
        for (int m = 0; m < total; ++m) staged += (list[m].w & kStagedBit) != 0;
        atomicAdd(paths, B - total);
        atomicAdd(paths + 1, staged);
        atomicAdd(paths + 2, total - staged);
    }

    // 2. the copy of entry m's box, if staged, into buffer m % kStages: this thread's pair of cells
    const bool copier = t < kBoxRows * kBoxPairs;
    const int copy_src = (t / kBoxPairs) * B + 2 * (t % kBoxPairs);  // cells from the buffer's origin in the layout
    const int copy_dst = (t / kBoxPairs) * kBoxCols + 2 * (t % kBoxPairs);
    auto issue = [&](int m) {
        if (m < total && copier) {
            const int4 en = list[m];
            if (en.w & kStagedBit)
                __pipeline_memcpy_async(boxes + (m & (kStages - 1)) * kBoxCells + copy_dst,
                                        field + (unsigned)(en.y + copy_src), 16);
        }
        __pipeline_commit();
    };

    // 3. the composite, front to back over the list
    const float base_y = base_coord(j, a.box[0], a.box[1], Bi);
    const float base_x = base_coord(i, a.box[2], a.box[3], Bi);
    const float dby = __fsub_rn(base_y, ey), dbx = __fsub_rn(base_x, ex);
    // the ray's obliquity: path length per slice = cell_world · sec
    const float sec = __fdiv_rn(
        __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(dby, dby), __fmul_rn(dbx, dbx)), __fmul_rn(dz0, dz0))), fabsf(dz0));
    const float dt = __fmul_rn(a.cell_world, sec);
    float ctau = 0.0f, acc[3] = {0.0f, 0.0f, 0.0f}, depth = 0.0f;
    float4* const row_lerps = lerps + jl * kTileX;
#pragma unroll
    for (int m = 0; m < kStages - 1; ++m) issue(m);
    for (int m = 0; m < total; ++m) {
        __pipeline_wait_prior(kStages - 2);
        __syncthreads();  // entry m's box is in; every thread is done with entry m - 1 and its buffer
        issue(m + kStages - 1);
        const int4 en = list[m];
        const float2 sl = terms[en.x];
        const Src sy = source(base_y, ey, sl.y, B);
        const Src sx = source(base_x, ex, sl.y, B);
        const bool row = j < Bi && sy.valid;
        const int x_lo = en.w & 0xffff;
        float v[4];
        if (en.w & kStagedBit) {
            // the lanes of a row y-lerp the footprint's columns, one each (the separable resample's first pass,
            // shared by the row's texels), then each texel x-lerps two of them
            const int col = ((en.w >> 16) & 0xff) + il;  // the buffer column of cell x_lo + il
            if (row && col < kBoxCols) {
                const uint2* b = boxes + (m & (kStages - 1)) * kBoxCells + (sy.q0 - en.z) * kBoxCols + col;
                float lo[4], hi[4];
                unpack(b[0], lo);
                unpack(b[kBoxCols], hi);
                row_lerps[il] = make_float4(lerp_rn(lo[0], hi[0], sy.frac), lerp_rn(lo[1], hi[1], sy.frac),
                                            lerp_rn(lo[2], hi[2], sy.frac), lerp_rn(lo[3], hi[3], sy.frac));
            }
            __syncwarp();
            if (!(row && i < Bi && sx.valid)) continue;  // off the slice
            const float4 l = row_lerps[sx.q0 - x_lo], r = row_lerps[sx.q0 - x_lo + 1];
            v[0] = lerp_rn(l.x, r.x, sx.frac);
            v[1] = lerp_rn(l.y, r.y, sx.frac);
            v[2] = lerp_rn(l.z, r.z, sx.frac);
            v[3] = lerp_rn(l.w, r.w, sx.frac);
        } else {
            if (!(row && i < Bi && sx.valid)) continue;  // off the slice
            const uint2* r0 = field + ((long long)(a.flip ? B - 1 - en.x : en.x) * B + sy.q0) * B + sx.q0;
            float t00[4], t01[4], t10[4], t11[4];  // t[y][x]
            unpack(__ldg(r0), t00);
            unpack(__ldg(r0 + 1), t01);
            unpack(__ldg(r0 + B), t10);
            unpack(__ldg(r0 + B + 1), t11);
#pragma unroll
            for (int c = 0; c < 4; ++c)
                v[c] = lerp_rn(lerp_rn(t00[c], t10[c], sy.frac), lerp_rn(t01[c], t11[c], sy.frac), sx.frac);
        }
        const float tau = __fmul_rn(fmaxf(v[3], 0.0f), dt);
        const float c_new = __fadd_rn(ctau, tau);
        const float w = __fmul_rn(expf(-__fsub_rn(c_new, tau)), __fsub_rn(1.0f, expf(-tau)));
        ctau = c_new;
#pragma unroll
        for (int c = 0; c < 3; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(w, v[c]));
        if (a.with_depth) depth = __fadd_rn(depth, __fmul_rn(w, __fmul_rn(__fmul_rn(sl.x, sec), a.cell_world)));
    }

    // 4. the tile's raster rows through shared memory (the box buffers are free now)
    __pipeline_wait_prior(0);
    __syncthreads();
    float* const rows = reinterpret_cast<float*>(smem);  // [kTileX (x')][kOutPitch]
    if (i < Bi && j < Bi) {
        float* o = rows + il * kOutPitch + jl * 5;
        o[0] = acc[0];
        o[1] = acc[1];
        o[2] = acc[2];
        o[3] = __fsub_rn(1.0f, expf(-ctau));
        o[4] = depth;
    }
    __syncthreads();
    const int ni = min(kTileX, Bi - i0), nc = min(kTileY, Bi - j0) * 5;
    for (int e = t; e < kTileX * kTileY * 5; e += kThreads) {
        const int r = e / (kTileY * 5), c = e - r * (kTileY * 5);
        if (r < ni && c < nc) raster[((long long)(i0 + r) * Bi + j0) * 5 + c] = rows[r * kOutPitch + c];
    }
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

int launch_composite(const FrameArgs* args, const void* field, void* raster, int* paths, void* stream) {
    if (args == nullptr || args->B < 2 || args->Bi < 2 || args->B > kMaxB || (uintptr_t)field % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((args->Bi + kTileX - 1) / kTileX), (unsigned)((args->Bi + kTileY - 1) / kTileY));
    composite_kernel<<<grid, kThreads, composite_smem(args->B), (cudaStream_t)stream>>>(*args, (const uint2*)field,
                                                                                       (float*)raster, paths);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nst_shear_composite(const FrameArgs* args, const void* field, void* raster, void* stream) {
    return launch_composite(args, field, raster, nullptr, stream);
}

// the same launch, adding the tile-slices it skipped, staged and read directly to paths[0..2] (int32)
extern "C" int nst_shear_composite_paths(const FrameArgs* args, const void* field, void* raster, void* paths,
                                         void* stream) {
    return launch_composite(args, field, raster, (int*)paths, stream);
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
