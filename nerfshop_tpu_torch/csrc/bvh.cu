// Kernel G: signed distance to a closed triangle mesh by walking its BVH.
//
// Replaces the XLA while_loop of nerfshop_tpu/geometry/bvh.py::signed_distance
// (:196-268, vmapped over the points; the SDF testbed's ground truth, not a
// Pallas kernel) with _closest_point_tri (:138-188). Same inputs and output:
//   points [N, 3] f32
//   the arrays of build_bvh (struct BvhArgs below): node boxes [Nn, 3] x 2,
//   left child and leaf slot [Nn] int32 (right child = left + 1), leaf
//   triangles [Lf, 4] int32 padded with the sentinel triangle F, and per
//   triangle (F + 1 rows) corner a, edges ab and ac, face normal, vertex and
//   edge pseudo-normals [F + 1, 3, 3]
//   out [N] f32: the distance to the closest triangle, signed by the
//   pseudo-normal of the closest feature (face, vertex or edge) of it.
// The traversal is JAX's: a stack of MAX_STACK node indices, a node is
// skipped when its box is not strictly nearer than the best squared
// distance, a leaf keeps its first strictly nearer triangle, and an inner
// node pushes the farther child first so that the nearer one is visited
// next. A median-split tree of F triangles is at most log2(F) + 1 deep, so
// the stack (depth + 1 entries) never overflows 64.
//
// What bounds it on the H100: neither bytes nor operations at the floor.
// The least it must move is the points, the output and the BVH once (~16 MB
// for 81920 faces, 5 us at 3.35 TB/s), but each point reads the nodes and
// leaves of its own walk: a divergent, latency-bound loop of dependent
// loads (a few dozen nodes and leaves a point near the surface, more far
// from it), with the top of the tree in L1/L2.
//
// Design (a first version, simple and right): one thread a point, the stack
// in local memory, the node and triangle arrays read through the read-only
// path. Sorting the points by Morton code (coherent walks in a warp) and a
// wider tree are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxStack = 64;  // geometry/bvh.py MAX_STACK
constexpr int kLeafSize = 4;  // geometry/bvh.py LEAF_SIZE

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 ld3(const float* p, long long i) {
    return V3{__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return V3{a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 mul(float s, V3 a) { return V3{s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// Ericson's closest point on triangle (a, a + ab, a + ac) to p, and its
// region: 0 face, 1-3 vertex a/b/c, 4-6 edge ab/bc/ca; the precedence of
// JAX's where chain (a, b, c, ab, bc, ca, then the face)
__device__ V3 closest_point(V3 p, V3 a, V3 ab, V3 ac, int& reg) {
    const V3 ap = sub(p, a);
    const float d1 = dot(ab, ap), d2 = dot(ac, ap);
    const V3 bp = sub(p, add(a, ab));
    const float d3 = dot(ab, bp), d4 = dot(ac, bp);
    const V3 cp = sub(p, add(a, ac));
    const float d5 = dot(ab, cp), d6 = dot(ac, cp);
    if (d1 <= 0.f && d2 <= 0.f) { reg = 1; return a; }
    if (d3 >= 0.f && d4 <= d3) { reg = 2; return add(a, ab); }
    if (d6 >= 0.f && d5 <= d6) { reg = 3; return add(a, ac); }
    if (d1 * d4 - d3 * d2 <= 0.f && d1 >= 0.f && d3 <= 0.f) {
        reg = 4;
        return add(a, mul(d1 / fmaxf(d1 - d3, 1e-30f), ab));
    }
    if (d3 * d6 - d5 * d4 <= 0.f && d4 - d3 >= 0.f && d5 - d6 >= 0.f) {
        reg = 5;
        const float t = (d4 - d3) / fmaxf((d4 - d3) + (d5 - d6), 1e-30f);
        return add(add(a, ab), mul(t, sub(ac, ab)));
    }
    if (d5 * d2 - d1 * d6 <= 0.f && d2 >= 0.f && d6 <= 0.f) {
        reg = 6;
        return add(a, mul(d2 / fmaxf(d2 - d6, 1e-30f), ac));
    }
    reg = 0;
    const float va = d3 * d6 - d5 * d4, vb = d5 * d2 - d1 * d6, vc = d1 * d4 - d3 * d2;
    float denom = va + vb + vc;
    if (fabsf(denom) < 1e-30f) denom = 1e-30f;
    return add(a, add(mul(vb / denom, ab), mul(vc / denom, ac)));
}

__device__ __forceinline__ float box_dist2(V3 p, V3 lo, V3 hi) {
    const float dx = fmaxf(fmaxf(lo.x - p.x, p.x - hi.x), 0.f);
    const float dy = fmaxf(fmaxf(lo.y - p.y, p.y - hi.y), 0.f);
    const float dz = fmaxf(fmaxf(lo.z - p.z, p.z - hi.z), 0.f);
    return dx * dx + dy * dy + dz * dz;
}

}  // namespace

// the arrays of geometry/bvh.py BvhArrays, in its field order
struct BvhArgs {
    const float* node_min;
    const float* node_max;
    const int* node_left;
    const int* node_leaf;
    const int* leaf_tris;
    const float* tri_a;
    const float* tri_ab;
    const float* tri_ac;
    const float* tri_pv;
    const float* tri_pe;
    const float* tri_n;
};

namespace {

__global__ void __launch_bounds__(kThreads)
bvh_sdf_kernel(const BvhArgs b, const float* __restrict__ points, float* __restrict__ out, int n) {
    const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (i >= n) return;
    const V3 p = ld3(points, i);
    int stack[kMaxStack];
    int sp = 1;
    stack[0] = 0;
    float best_d2 = 1e30f;
    int best_tri = -1;
    V3 best_pt = V3{0.f, 0.f, 0.f};
    while (sp > 0) {
        const int ni = stack[--sp];
        if (!(box_dist2(p, ld3(b.node_min, ni), ld3(b.node_max, ni)) < best_d2)) continue;
        const int leaf = __ldg(b.node_leaf + ni);
        if (leaf >= 0) {
#pragma unroll
            for (int j = 0; j < kLeafSize; ++j) {
                const int t = __ldg(b.leaf_tris + kLeafSize * leaf + j);
                int reg;
                const V3 pt = closest_point(p, ld3(b.tri_a, t), ld3(b.tri_ab, t), ld3(b.tri_ac, t), reg);
                const V3 d = sub(pt, p);
                const float d2 = d.x * d.x + d.y * d.y + d.z * d.z;
                if (d2 < best_d2) best_d2 = d2, best_tri = t, best_pt = pt;
            }
        } else {
            const int li = __ldg(b.node_left + ni);
            const float dl = box_dist2(p, ld3(b.node_min, li), ld3(b.node_max, li));
            const float dr = box_dist2(p, ld3(b.node_min, li + 1), ld3(b.node_max, li + 1));
            const bool left_first = dl <= dr;
            stack[sp] = left_first ? li + 1 : li;
            stack[sp + 1] = left_first ? li : li + 1;
            sp += 2;
        }
    }
    if (best_tri < 0) {  // no triangle: the empty mesh
        out[i] = 1e30f;
        return;
    }
    int reg;
    closest_point(p, ld3(b.tri_a, best_tri), ld3(b.tri_ab, best_tri), ld3(b.tri_ac, best_tri), reg);
    V3 normal;
    if (reg == 0) normal = ld3(b.tri_n, best_tri);
    else if (reg <= 3) normal = ld3(b.tri_pv, 3LL * best_tri + reg - 1);
    else normal = ld3(b.tri_pe, 3LL * best_tri + reg - 4);
    const float s = dot(sub(p, best_pt), normal) >= 0.f ? 1.f : -1.f;
    out[i] = s * sqrtf(best_d2);
}

}  // namespace

// out [n] f32 from points [n, 3] f32 and the BVH *args (all on the device)
extern "C" int nst_bvh_sdf(const BvhArgs* args, const void* points, void* out, int n, void* stream) {
    if (args == nullptr || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
    bvh_sdf_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(*args, (const float*)points, (float*)out, n);
    return (int)cudaGetLastError();
}
