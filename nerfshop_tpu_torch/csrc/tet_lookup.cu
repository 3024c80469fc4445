// Kernel E: the cage warp. Point-in-tet lookups through a packed uniform-grid
// LUT of candidate tets, and the whole warp of a cage operator around them.
//
// Replaces, in nerfshop_tpu/editing/operators.py,
//   tet_lookup (operators.py:74): the candidate loop, which XLA runs as a
//     lax.fori_loop over the LUT's widest cell with ~12 elementwise ops on
//     [N] arrays per candidate;
//   cage_map_samples (:150) and cage_map_positions (:177): two lookups, the
//     per-tet row takes, the barycentric delta, the rotation and the flags,
//     which XLA fuses into one program;
//   the cage step of map_samples_through_stack_full (:291-326) with
//     membrane_residuals_at (editing/poisson.py:143): the sample warp, then
//     four per-tet row takes, the barycentric sums and an SH9 evaluation.
// Four template instances of one kernel:
//   LOOKUP          (found, tet, bary) of one lookup, as tet_lookup;
//   WARP_SAMPLES    (pos', dir', empty, in_target) of cage_map_samples;
//   WARP_POSITIONS  (pos', kill) of cage_map_positions;
//   WARP_MEMBRANE   WARP_SAMPLES's results, and the membrane's residual
//                   sigma, outside sigma and residual rgb of each in-target
//                   point ADDED into accumulators the caller zeroes once for
//                   the whole operator stack, so that a stack of cages sums in
//                   operator order as the JAX stack's += does. It evaluates
//                   at the tet and barycentrics its own warp found:
//                   rs = sum_k b_k rho_k, ro = sum_k b_k o_k (both times the
//                   amplitude), rgb_c = sum_j Y_j(dir') sum_k b_k sh_{k,j,c},
//                   with dir' the rotated, normalized direction. Points
//                   outside the target add nothing (JAX adds zeros).
// Semantics of a lookup:
//   cell  = floor((p - bbox_lo) * inv_cell), flat (x*res + y)*res + z;
//           outside the LUT box a point has no candidates;
//   score = min(w0, w1, w2, w3), w1..w3 = rows of inv_e dotted with p - v0,
//           w0 = ((1 - w1) - w2) - w3;
//   best  = the highest score; an exact tie goes to the earliest LUT
//           position; a NaN score never wins (the JAX running best with a
//           strict '>');
//   found = best >= threshold (eps if eps > 0, else -near_miss);
//   tet   = the winner, 0 when nothing scored; bary from that tet's row.
// The warps: in_target is the inclusive lookup (-0.08) in the deformed LUT;
// there pos' = p + ((((0 + b0*d0) + b1*d1) + b2*d2) + b3*d3) with d_k the
// tet's vertex deltas vo - vd, and dir' = R^T dir / (|R^T dir| + 1e-12);
// elsewhere p and dir pass through. in_source is the strict lookup (5e-3) in
// the original LUT; empty (kill) = in_source & !in_target & !copy_mode, so
// the strict lookup runs only for points outside the target.
//
// Inputs: per LUT, offsets [res^3 + 1] and ids [sum of fanouts] int32 (cell
// c lists ids[offsets[c] .. offsets[c+1]), in LUT order), the box by value,
// and the lookup rows [Nt, 12] f32 [v0 | inv_e row-major]; for the warps the
// vertex deltas vo - vd [Nt, 12] and the rotations [Nt, 12] (row-major, 3
// floats of padding). Every row is 48 bytes, three float4 loads. They are
// the sections of the operator's records, packed once when it is made. For
// WARP_MEMBRANE the membrane's rows [Nt, 120] f32, 30 float4s a tet: rho_0..3
// (residual density of the 4 corners), o_0..3 (outside density), then for
// each of the 27 (SH coefficient j, channel c) pairs, j*3 + c, the 4 corners'
// values, then 4 floats of padding; packed once when the membrane is made.
//
// What bounds it on the H100: bytes, and little of them: 12 bytes of
// position in, 21 out for a lookup; 24 in and 26 out for the sample warp.
// The LUTs and the records of a cage (~1 MiB of offsets, 4 bytes an id, 192
// bytes a tet) stay in the 50 MB L2, where the padded [res^3, widest
// fanout] LUT did not. What stood between the first kernel and that bound:
// one thread per point walked its own cell's list, so a warp ran as long as
// its lane with the widest cell (up to ~10^2 candidates, ~5 a point on
// average); each step was a chain of dependent loads (LUT entry, then 12
// scalar loads of the row); and the warp around it was ~30 launches per
// chunk.
//
// Design: each warp takes 32 points, one per lane, and lays their
// (point, candidate) pairs out as one queue in point order (a prefix sum of
// the fanouts over the lanes, kept with the points in shared memory). The
// queue is cut into 32 strips of equal length, one a lane, so a warp runs
// ceil(sum of fanouts / 32) steps instead of the widest fanout. A lane
// finds its strip's first point by a binary search over the prefix sums,
// then scores its strip in order with a running best per point, the loads
// of two candidates in flight together; where its strip leaves a point it
// folds the point's best into the point's 64-bit key in shared memory
// (atomicMax: score in order-preserving bits over the complement of the
// LUT position, so the integer max is the tie rule). A first version gave
// every lane one pair of the queue per round and folded the rounds by
// segmented scans over shuffles: it balanced the work as well, but its ~27
// shuffles a round made it slower than the first kernel on the edited
// frame's coherent points. Lanes walking their own points over the same
// packed rows (the first kernel's loop, two candidates in flight) came
// close to the strips on both the edited frame's points and random ones:
// most of the gain over the first kernel is the packed LUT and the float4
// rows; the strips bound a warp's time by its sum of fanouts where fanouts
// differ. Points outside the box have no pairs and cost their loads and
// pass-through stores. At random points the lookup rows of ~10 candidates
// a point come from all over the table; a quarter of the SM's memory is
// kept as shared memory so that the rest caches them in L1.
// Every product, sum and difference is rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn): no FMA contraction flips a containment test against
// the plain version, which computes the same expressions op by op.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// one LUT of a launch (kernels.py LutArgs)
struct LutArgs {
    const int* offsets;  // [res^3 + 1]
    const int* ids;      // [sum of fanouts]
    const float* rows;   // [Nt, 12] the tets' [v0 | inv_e row-major]
    float box[6];        // bbox_lo xyz, inv_cell xyz
    int res;
    float threshold;
};

// a launch (kernels.py CageArgs): a = the lookup's LUT, or the deformed LUT
// of a warp; b = the original LUT of a warp
struct CageArgs {
    LutArgs a;
    LutArgs b;
    const float* deltas;  // [Nt, 12] vo - vd, warps
    const float* rots;    // [Nt, 12] rotation row-major and 3 of padding, WARP_SAMPLES
    const float* p;       // [N, 3]
    const float* dir;     // [N, 3], WARP_SAMPLES
    float* pos_out;       // [N, 3], warps
    float* dir_out;       // [N, 3], WARP_SAMPLES
    uint8_t* flag0;       // [N] found (LOOKUP), empty / kill (warps)
    uint8_t* flag1;       // [N] in_target (WARP_SAMPLES)
    int* tet;             // [N] (LOOKUP)
    float* bary;          // [N, 4] (LOOKUP)
    long long n;
    int copy_mode;
    const float* membrane;  // [Nt, 120], WARP_MEMBRANE
    float* acc_sigma;       // [N] += residual sigma, WARP_MEMBRANE
    float* acc_out;         // [N] += outside sigma
    float* acc_rgb;         // [N, 3] += residual rgb
    float amplitude;
};

namespace {

enum Mode { LOOKUP = 0, WARP_SAMPLES = 1, WARP_POSITIONS = 2, WARP_MEMBRANE = 3 };

constexpr int THREADS = 256;
// candidates of one point scored together, their loads in flight together
constexpr int UNROLL = 2;
// the share of the SM's unified memory kept as shared memory, in percent:
// room for the slices of the 6 blocks the registers allow (8 KB each), the
// rest is L1 for the lookup rows
constexpr int SMEM_CARVEOUT = 25;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float nan_min(float a, float b) {
    // jnp.minimum / torch.minimum propagate NaN; fminf would drop it
    return (a != a || b != b) ? CUDART_NAN_F : fminf(a, b);
}

// a 48-byte row: a tet's [v0 | inv_e row-major], its vertex deltas or its rotation
struct Row {
    float4 a, b, c;
};

__device__ __forceinline__ Row load_row(const float* __restrict__ rows, int t) {
    const float4* r = reinterpret_cast<const float4*>(rows + (size_t)t * 12);
    return Row{__ldg(r), __ldg(r + 1), __ldg(r + 2)};
}

// barycentrics of q in the tet of row r
__device__ __forceinline__ void bary_of(const Row& r, float qx, float qy, float qz, float w[4]) {
    const float d0 = __fsub_rn(qx, r.a.x), d1 = __fsub_rn(qy, r.a.y), d2 = __fsub_rn(qz, r.a.z);
    w[1] = __fadd_rn(__fadd_rn(__fmul_rn(r.a.w, d0), __fmul_rn(r.b.x, d1)), __fmul_rn(r.b.y, d2));
    w[2] = __fadd_rn(__fadd_rn(__fmul_rn(r.b.z, d0), __fmul_rn(r.b.w, d1)), __fmul_rn(r.c.x, d2));
    w[3] = __fadd_rn(__fadd_rn(__fmul_rn(r.c.y, d0), __fmul_rn(r.c.z, d1)), __fmul_rn(r.c.w, d2));
    w[0] = __fsub_rn(__fsub_rn(__fsub_rn(1.0f, w[1]), w[2]), w[3]);
}

__device__ __forceinline__ float score_of(const Row& r, float qx, float qy, float qz) {
    float w[4];
    bary_of(r, qx, qy, qz, w);
    return nan_min(nan_min(w[0], w[1]), nan_min(w[2], w[3]));
}

// A candidate's rank: the score's bits made order-preserving over the
// complement of its LUT position, so that the larger key is the higher
// score and, among equal scores, the earlier position. 0 (below every key)
// for NaN and -inf, which never win.
__device__ __forceinline__ unsigned long long score_key(float score, int pos) {
    if (!(score > -CUDART_INF_F)) return 0ull;
    if (score == 0.0f) score = 0.0f;  // -0 and +0 tie
    unsigned u = __float_as_uint(score);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ((unsigned long long)u << 32) | (0xffffffffu - (unsigned)pos);
}

__device__ __forceinline__ float key_score(unsigned long long key) {
    unsigned u = (unsigned)(key >> 32);
    u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
    return __uint_as_float(u);
}

__device__ __forceinline__ int key_pos(unsigned long long key) { return (int)(0xffffffffu - (unsigned)key); }

struct Winner {
    float score;  // -inf when nothing scored
    int tet;      // 0 when nothing scored
};

// a warp's slice of the block's shared memory: its 32 points
struct WarpSlice {
    unsigned long long best[32];
    int start[32], fan[32], excl[32];
    float qx[32], qy[32], qz[32];
};

__device__ __forceinline__ void flush(unsigned long long* slot, float best, int pos) {
    const unsigned long long key = score_key(best, pos);
    if (key) atomicMax(slot, key);
}

// The best candidate of each lane's point in the LUT L (no candidates when
// !active). Called by the 32 lanes of a warp together: the warp's
// (point, candidate) pairs, in point order, are cut into 32 strips of equal
// length, one a lane; a lane scores its strip with a running best per point
// (UNROLL candidates of one point at a time, their loads issued together)
// and folds each point's best into the point's key in shared memory.
__device__ __forceinline__ Winner best_candidate(const LutArgs& L, float px, float py, float pz, bool active,
                                                 WarpSlice& S) {
    const int lane = threadIdx.x & 31;
    int start = 0, fan = 0;
    if (active) {
        const float fx = floorf(__fmul_rn(__fsub_rn(px, L.box[0]), L.box[3]));
        const float fy = floorf(__fmul_rn(__fsub_rn(py, L.box[1]), L.box[4]));
        const float fz = floorf(__fmul_rn(__fsub_rn(pz, L.box[2]), L.box[5]));
        const float fres = (float)L.res;
        if (fx >= 0.f && fx < fres && fy >= 0.f && fy < fres && fz >= 0.f && fz < fres) {
            const long long ci = ((long long)(int)fx * L.res + (int)fy) * L.res + (int)fz;
            start = __ldg(L.offsets + ci);
            fan = __ldg(L.offsets + ci + 1) - start;
        }
    }
    int incl = fan;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += o;
    }
    const int total = __shfl_sync(FULL, incl, 31);
    Winner w{-CUDART_INF_F, 0};
    if (total == 0) return w;  // the same on every lane
    S.start[lane] = start;
    S.fan[lane] = fan;
    S.excl[lane] = incl - fan;
    S.qx[lane] = px;
    S.qy[lane] = py;
    S.qz[lane] = pz;
    S.best[lane] = 0ull;
    __syncwarp();
    const int lo = (lane * total) >> 5, hi = ((lane + 1) * total) >> 5;
    if (lo < hi) {
        int o = 0;  // the point of pair lo: the last lane whose exclusive prefix is <= lo
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
            if (S.excl[o + step] <= lo) o += step;
        }
        int k = lo - S.excl[o], fan_o = S.fan[o];
        const int* ids = L.ids + S.start[o];
        float qx = S.qx[o], qy = S.qy[o], qz = S.qz[o];
        float best = -CUDART_INF_F;
        int bpos = 0;
        for (int j = lo; j < hi;) {
            if (k == fan_o) {  // on to the next point with candidates
                flush(S.best + o, best, bpos);
                best = -CUDART_INF_F;
                do {
                    ++o;
                } while (S.fan[o] == 0);
                k = 0;
                fan_o = S.fan[o];
                ids = L.ids + S.start[o];
                qx = S.qx[o];
                qy = S.qy[o];
                qz = S.qz[o];
            }
            if (UNROLL > 1 && min(fan_o - k, hi - j) >= UNROLL) {
                int t[UNROLL];
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) t[u] = __ldg(ids + k + u);
                Row r[UNROLL];
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) r[u] = load_row(L.rows, t[u]);
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    const float score = score_of(r[u], qx, qy, qz);
                    if (score > best) {  // strict: the earlier of equal scores stays
                        best = score;
                        bpos = k + u;
                    }
                }
                k += UNROLL;
                j += UNROLL;
            } else {
                const float score = score_of(load_row(L.rows, __ldg(ids + k)), qx, qy, qz);
                if (score > best) {
                    best = score;
                    bpos = k;
                }
                ++k;
                ++j;
            }
        }
        flush(S.best + o, best, bpos);
    }
    __syncwarp();
    const unsigned long long key = S.best[lane];
    __syncwarp();  // the slice is free again
    if (key) {
        w.score = key_score(key);
        w.tet = __ldg(L.ids + start + key_pos(key));
    }
    return w;
}

// sum_k b_k q_k, summed from 0 in k order
__device__ __forceinline__ float bary_dot(const float b[4], float4 q) {
    float s = __fmul_rn(b[0], q.x);
    s = __fadd_rn(s, __fmul_rn(b[1], q.y));
    s = __fadd_rn(s, __fmul_rn(b[2], q.z));
    return __fadd_rn(s, __fmul_rn(b[3], q.w));
}

// WARP_MEMBRANE: the membrane's residuals of in-target point i in tet t at
// barycentrics b and warped direction (x, y, z), added into the accumulators
__device__ __forceinline__ void add_membrane(const CageArgs& A, long long i, int t, const float b[4], float x,
                                             float y, float z) {
    const float4* m = reinterpret_cast<const float4*>(A.membrane + (size_t)t * 120);
    const float rs = bary_dot(b, __ldg(m + 0));
    const float ro = bary_dot(b, __ldg(m + 1));
    // the real SH basis l <= 2 (ops/sh.py sh9_basis)
    const float C0 = 0.28209479177387814f, C1 = 0.4886025119029199f, C2a = 1.0925484305920792f,
                C2b = 0.31539156525252005f, C2c = 0.5462742152960396f;
    const float Y[9] = {
        C0,
        -C1 * y,
        C1 * z,
        -C1 * x,
        __fmul_rn(__fmul_rn(C2a, x), y),
        __fmul_rn(__fmul_rn(-C2a, y), z),
        __fmul_rn(C2b, __fsub_rn(__fmul_rn(__fmul_rn(3.0f, z), z), 1.0f)),
        __fmul_rn(__fmul_rn(-C2a, x), z),
        __fmul_rn(C2c, __fsub_rn(__fmul_rn(x, x), __fmul_rn(y, y))),
    };
    float rgb[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 9; ++j) {
#pragma unroll
        for (int c = 0; c < 3; ++c) rgb[c] = __fadd_rn(rgb[c], __fmul_rn(Y[j], bary_dot(b, __ldg(m + 2 + 3 * j + c))));
    }
    A.acc_sigma[i] = __fadd_rn(A.acc_sigma[i], __fmul_rn(rs, A.amplitude));
    A.acc_out[i] = __fadd_rn(A.acc_out[i], __fmul_rn(ro, A.amplitude));
#pragma unroll
    for (int c = 0; c < 3; ++c) A.acc_rgb[3 * i + c] = __fadd_rn(A.acc_rgb[3 * i + c], rgb[c]);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) cage_kernel(const CageArgs A) {
    __shared__ WarpSlice slices[THREADS / 32];
    WarpSlice& S = slices[threadIdx.x >> 5];
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = i < A.n;
    float px = 0.f, py = 0.f, pz = 0.f;
    if (live) {
        px = __ldg(A.p + 3 * i + 0);
        py = __ldg(A.p + 3 * i + 1);
        pz = __ldg(A.p + 3 * i + 2);
    }
    const Winner w = best_candidate(A.a, px, py, pz, live, S);

    if (MODE == LOOKUP) {
        if (!live) return;
        float bw[4];
        bary_of(load_row(A.a.rows, w.tet), px, py, pz, bw);
        A.flag0[i] = w.score >= A.a.threshold ? 1 : 0;
        A.tet[i] = w.tet;
        reinterpret_cast<float4*>(A.bary)[i] = make_float4(bw[0], bw[1], bw[2], bw[3]);
        return;
    }

    constexpr bool SAMPLES = MODE == WARP_SAMPLES || MODE == WARP_MEMBRANE;
    const bool in_target = live && w.score >= A.a.threshold;
    float ox = px, oy = py, oz = pz;
    float dx = 0.f, dy = 0.f, dz = 0.f;
    float bw[4];
    if (SAMPLES && live) {
        dx = __ldg(A.dir + 3 * i + 0);
        dy = __ldg(A.dir + 3 * i + 1);
        dz = __ldg(A.dir + 3 * i + 2);
    }
    float ex = dx, ey = dy, ez = dz;
    if (in_target) {
        bary_of(load_row(A.a.rows, w.tet), px, py, pz, bw);
        const Row dv = load_row(A.deltas, w.tet);
        const float d[12] = {dv.a.x, dv.a.y, dv.a.z, dv.a.w, dv.b.x, dv.b.y, dv.b.z, dv.b.w, dv.c.x, dv.c.y, dv.c.z, dv.c.w};
        float sx = 0.f, sy = 0.f, sz = 0.f;  // summed from 0 in k order, as the plain version
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            sx = __fadd_rn(sx, __fmul_rn(bw[k], d[3 * k + 0]));
            sy = __fadd_rn(sy, __fmul_rn(bw[k], d[3 * k + 1]));
            sz = __fadd_rn(sz, __fmul_rn(bw[k], d[3 * k + 2]));
        }
        ox = __fadd_rn(px, sx);
        oy = __fadd_rn(py, sy);
        oz = __fadd_rn(pz, sz);
        if (SAMPLES) {
            const Row rv = load_row(A.rots, w.tet);
            const float R[9] = {rv.a.x, rv.a.y, rv.a.z, rv.a.w, rv.b.x, rv.b.y, rv.b.z, rv.b.w, rv.c.x};
            // (R^T dir)_j = R[0][j] dx + R[1][j] dy + R[2][j] dz
            float nv[3];
#pragma unroll
            for (int j = 0; j < 3; ++j) {
                nv[j] = __fadd_rn(__fadd_rn(__fmul_rn(R[j], dx), __fmul_rn(R[3 + j], dy)), __fmul_rn(R[6 + j], dz));
            }
            const float len = __fadd_rn(
                __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(nv[0], nv[0]), __fmul_rn(nv[1], nv[1])), __fmul_rn(nv[2], nv[2]))),
                1e-12f);
            ex = __fdiv_rn(nv[0], len);
            ey = __fdiv_rn(nv[1], len);
            ez = __fdiv_rn(nv[2], len);
        }
    }

    // the strict lookup only decides points outside the target
    const bool want_source = live && !in_target && !A.copy_mode;
    bool empty = false;
    if (!A.copy_mode) {  // the same on every lane
        const Winner s = best_candidate(A.b, px, py, pz, want_source, S);
        empty = want_source && s.score >= A.b.threshold;
    }
    if (!live) return;
    A.pos_out[3 * i + 0] = ox;
    A.pos_out[3 * i + 1] = oy;
    A.pos_out[3 * i + 2] = oz;
    A.flag0[i] = empty ? 1 : 0;
    if (SAMPLES) {
        A.dir_out[3 * i + 0] = ex;
        A.dir_out[3 * i + 1] = ey;
        A.dir_out[3 * i + 2] = ez;
        A.flag1[i] = in_target ? 1 : 0;
    }
    if (MODE == WARP_MEMBRANE && in_target) add_membrane(A, i, w.tet, bw, ex, ey, ez);
}

}  // namespace

extern "C" int nst_cage(const CageArgs* args, int mode, void* stream) {
    if (args->n <= 0) return (int)cudaGetLastError();
    const unsigned blocks = (unsigned)((args->n + THREADS - 1) / THREADS);
    cudaStream_t s = (cudaStream_t)stream;
    static bool carved = false;
    if (!carved) {
        cudaFuncSetAttribute(cage_kernel<LOOKUP>, cudaFuncAttributePreferredSharedMemoryCarveout, SMEM_CARVEOUT);
        cudaFuncSetAttribute(cage_kernel<WARP_SAMPLES>, cudaFuncAttributePreferredSharedMemoryCarveout, SMEM_CARVEOUT);
        cudaFuncSetAttribute(cage_kernel<WARP_POSITIONS>, cudaFuncAttributePreferredSharedMemoryCarveout, SMEM_CARVEOUT);
        cudaFuncSetAttribute(cage_kernel<WARP_MEMBRANE>, cudaFuncAttributePreferredSharedMemoryCarveout, SMEM_CARVEOUT);
        carved = true;
    }
    switch (mode) {
        case LOOKUP: cage_kernel<LOOKUP><<<blocks, THREADS, 0, s>>>(*args); break;
        case WARP_SAMPLES: cage_kernel<WARP_SAMPLES><<<blocks, THREADS, 0, s>>>(*args); break;
        case WARP_POSITIONS: cage_kernel<WARP_POSITIONS><<<blocks, THREADS, 0, s>>>(*args); break;
        case WARP_MEMBRANE: cage_kernel<WARP_MEMBRANE><<<blocks, THREADS, 0, s>>>(*args); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
