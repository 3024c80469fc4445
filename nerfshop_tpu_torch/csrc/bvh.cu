// Kernels G and N: signed distance to a closed triangle mesh, and the
// nearest hit of rays on it, by walking its BVH.
//
// Kernel G:
// Replaces the XLA while_loop of nerfshop_tpu/geometry/bvh.py::signed_distance
// (:196-268, vmapped over the points; the SDF testbed's ground truth, not a
// Pallas kernel) with _closest_point_tri (:138-188). Same inputs and output:
//   points [N, 3] f32
//   the BVH of build_bvh, packed once a mesh by geometry/bvh.py::pack_bvh
//   (struct BvhArgs below)
//   out [N] f32: the distance to the closest triangle, signed by the
//   pseudo-normal of the closest feature (face, vertex or edge) of it.
// The traversal is JAX's: the nearer child is visited first (ties to the
// left), a box is skipped unless it is strictly nearer than the best squared
// distance, and within a leaf, in leaf order, the first strictly nearer
// triangle wins; the same closest-point arithmetic and pseudo-normal sign.
// So the distance and the triangle chosen are those of the first version.
//
// What bounds it on the H100: neither bytes nor operations at the floor.
// The least it must move is the points, the output and the BVH once (~16 MB
// for 81920 faces, 5 us at 3.35 TB/s), but each point reads the nodes and
// leaves of its own walk: a latency-bound chain of dependent loads, with
// the whole packed tree (~6 MB at 81920 faces) in L2. A point far from the
// surface (the uniform quarter of a training batch, all of an IoU's) visits
// every leaf whose box is nearer than its distance, thousands of nodes near
// the centre of a closed mesh, so the slowest walks set the pace of a small
// launch and the sum of the walks that of a large one.
//
// Design:
// - A record per inner node holds both children's boxes and links (Aila and
//   Laine's two-child layout, HPG 2009): 4 float4 loads a visit test both
//   children, with no dependent load between them. A child that is a leaf
//   links to its triangles' range, ~((start << 2) | (count - 1)).
// - Triangles in leaf order, three float4 each (a and the triangle's index,
//   ab, ac), the sentinel padding dropped: it is never strictly nearer than
//   the real triangles before it.
// - A stack of (child, box distance), one entry a level below the root at
//   most (pack_bvh refuses a deeper tree), sized at compile time: the
//   farther child is pushed with its distance and tested again when it is
//   popped. It is indexed at run time, so it lives in local memory (cached
//   in L1), which measured faster than the same stack in shared memory.
// - 4 lanes a point, one a leaf slot, 16 points a block of 64 threads: the
//   lanes of a point walk the same nodes, test a leaf's triangles one each
//   and combine their nearest (ties to the lower leaf slot) with
//   __shfl_xor_sync, which shortens the slowest walks.
// - The points are walked as given: sorting them in Morton order measured
//   slower at a training batch's 2^15 points (it gathers the far points
//   into the same warps) and saved ~10% at an IoU's 2^18 (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int kLeafSize = 4;  // geometry/bvh.py LEAF_SIZE
constexpr int kLanes = kLeafSize;  // lanes a point: one a leaf slot
constexpr int kThreads = 64;
constexpr int kGroups = kThreads / kLanes;  // points a block
constexpr int kStack = 32;  // geometry/bvh.py MAX_DEPTH - 1

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
__device__ __forceinline__ V3 closest_point(V3 p, V3 a, V3 ab, V3 ac, int& reg) {
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

// the squared distance from p to the triangle in packed slot s, and its
// closest point's region (only the distance is kept in the walk)
__device__ __forceinline__ float tri_dist2(const float4* __restrict__ tris, V3 p, long long s, V3& pt, int& reg,
                                           int& tri) {
    const float4 t0 = __ldg(tris + 3 * s), t1 = __ldg(tris + 3 * s + 1), t2 = __ldg(tris + 3 * s + 2);
    tri = __float_as_int(t0.w);
    pt = closest_point(p, V3{t0.x, t0.y, t0.z}, V3{t1.x, t1.y, t1.z}, V3{t2.x, t2.y, t2.z}, reg);
    const V3 d = sub(pt, p);
    return d.x * d.x + d.y * d.y + d.z * d.z;
}

}  // namespace

// the packed BVH of geometry/bvh.py PackedBvh (nodes, tris) and the
// pseudo-normal arrays of its BvhArrays
struct BvhArgs {
    const float4* nodes;  // [Ni, 4]: lo_l.xyz hi_l.x | hi_l.yz lo_r.xy | lo_r.z hi_r.xyz | link_l link_r 0 0
    const float4* tris;  // [F, 3]: a.xyz (index bits) | ab.xyz 0 | ac.xyz 0, in leaf order
    const float* tri_pv;  // [F + 1, 3, 3] vertex pseudo-normals at the corners
    const float* tri_pe;  // [F + 1, 3, 3] edge pseudo-normals (ab, bc, ca)
    const float* tri_n;  // [F + 1, 3] face normals
};

namespace {

// the nearest of a leaf's triangles (link `code`) to p over this point's
// lanes → its squared distance (+inf for none) in ld and its packed slot in
// ls; ties go to the lower slot, as a walk of the leaf in slot order keeps
// the first strictly nearer triangle
__device__ __forceinline__ void leaf_min(const float4* __restrict__ tris, V3 p, int code, int lane, unsigned gmask,
                                         float& ld, int& ls) {
    const int start = (~code) >> 2, count = ((~code) & 3) + 1;
    ld = __int_as_float(0x7f800000);
    ls = start + kLeafSize;
    if (lane < count) {
        V3 pt;
        int reg, tri;
        const float d2 = tri_dist2(tris, p, (long long)start + lane, pt, reg, tri);
        if (d2 < ld) ld = d2, ls = start + lane;
    }
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) {
        const float od = __shfl_xor_sync(gmask, ld, off, kLanes);
        const int os = __shfl_xor_sync(gmask, ls, off, kLanes);
        if (od < ld || (od == ld && os < ls)) ld = od, ls = os;
    }
}

__global__ void __launch_bounds__(kThreads)
bvh_sdf_kernel(const BvhArgs b, const float* __restrict__ points, float* __restrict__ out, int n) {
    int st_link[kStack];  // the farther children pushed, and their box distances
    float st_d[kStack];
    const long long i = (long long)blockIdx.x * kGroups + threadIdx.x / kLanes;
    if (i >= n) return;  // all lanes of a point together
    const int lane = threadIdx.x % kLanes;
    const unsigned gmask = ((1u << kLanes) - 1u) << ((threadIdx.x & 31) & ~(kLanes - 1));
    const V3 p = ld3(points, i);
    float best = 1e30f;
    int best_slot = -1;
    int sp = 0;
    int node = 0;
    for (;;) {
        // visit inner record `node`: test both children
        const float4* r = b.nodes + 4LL * node;
        const float4 r0 = __ldg(r), r1 = __ldg(r + 1), r2 = __ldg(r + 2);
        const int4 r3 = __ldg(reinterpret_cast<const int4*>(r) + 3);
        const float dl = box_dist2(p, V3{r0.x, r0.y, r0.z}, V3{r0.w, r1.x, r1.y});
        const float dr = box_dist2(p, V3{r1.z, r1.w, r2.x}, V3{r2.y, r2.z, r2.w});
        int next = 0;
        bool go = true;
        if (dl < best && dr < best) {
            const bool left_first = dl <= dr;
            next = left_first ? r3.x : r3.y;
            st_link[sp] = left_first ? r3.y : r3.x;
            st_d[sp] = left_first ? dr : dl;
            ++sp;
        } else if (dl < best) {
            next = r3.x;
        } else if (dr < best) {
            next = r3.y;
        } else {
            go = false;
        }
        // leaves, and pops, until the next inner record
        for (;;) {
            if (go) {
                if (next >= 0) break;
                float ld;
                int ls;
                leaf_min(b.tris, p, next, lane, gmask, ld, ls);
                if (ld < best) best = ld, best_slot = ls;
            }
            go = false;
            while (sp > 0) {
                --sp;
                if (st_d[sp] < best) {
                    next = st_link[sp];
                    go = true;
                    break;
                }
            }
            if (!go) break;
        }
        if (!go) break;
        node = next;
    }
    if (lane != 0) return;
    if (best_slot < 0) {  // nothing nearer than 1e30: a NaN point, or one ~1e15 away
        out[i] = 1e30f;
        return;
    }
    V3 pt;
    int reg, tri;
    tri_dist2(b.tris, p, best_slot, pt, reg, tri);
    V3 normal;
    if (reg == 0) normal = ld3(b.tri_n, tri);
    else if (reg <= 3) normal = ld3(b.tri_pv, 3LL * tri + reg - 1);
    else normal = ld3(b.tri_pe, 3LL * tri + reg - 4);
    const float s = dot(sub(p, pt), normal) >= 0.f ? 1.f : -1.f;
    out[i] = s * sqrtf(best);
}

}  // namespace

// out [n] f32 from points [n, 3] f32 and the packed BVH *args (all on the
// device)
extern "C" int nst_bvh_sdf(const BvhArgs* args, const void* points, void* out, int n, void* stream) {
    if (args == nullptr || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const dim3 grid((unsigned)((n + kGroups - 1) / kGroups));
    bvh_sdf_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(*args, (const float*)points, (float*)out, n);
    return (int)cudaGetLastError();
}

// Kernel N: the nearest hit of rays on the mesh, by walking the same packed
// BVH as G (a mesh packed once serves both).
//
// Replaces the XLA while_loop of nerfshop_tpu/geometry/bvh.py::ray_intersect
// (:271-338, vmapped over the rays; not a Pallas kernel). Same inputs and
// outputs:
//   origins, directions [N, 3] f32
//   t [N] f32: the nearest hit's distance along the ray, 1e8 on a miss
//   tri [N] int32: the hit triangle's index, -1 on a miss.
// JAX's arithmetic: the direction's inverse 1 / where(|d| < 1e-12, 1e-12, d)
// (a tiny negative component becomes +1e-12), the slab test tf >= max(tn, 0)
// && tn < t_best, Moller-Trumbore with det clamped the same way, a hit on
// u >= 0, v >= 0, u + v <= 1 and 1e-6 < t < t_best. The walk visits the
// nearer child first (JAX's pops the right one first), so at an exact tie in
// t it may keep another triangle than JAX; nvcc contracts the products into
// FMAs, so a ray that grazes an edge may flip between hit and miss.
//
// What bounds it on the H100: neither bytes nor operations at the floor.
// The least it must move is the rays, t and tri once (32 B a ray) and the
// packed tree once (~6 MB at 81920 faces): ~0.02 ms for a 1080p frame at
// 3.35 TB/s. Each ray walks a chain of dependent loads through the tree,
// held in L2, as G's points do; rays that miss the root's children stop
// after one record.
//
// Design (a simple walk, in the style of G's):
// - One record visit tests both children's boxes (4 float4 loads, no
//   dependent load between them) and goes to the nearer entry first; the
//   farther child is pushed with its entry distance tn and tested again
//   against t_best when it is popped. An empty box (lo > hi: the second
//   child of a root leaf) is never entered.
// - One thread a ray: it tests its leaf's triangles in slot order, keeping
//   the first strictly nearer. (Splitting a leaf over 4 lanes, as G does,
//   measured 1.2x slower at a 1080p camera's rays: PERF.md.) The stack is
//   G's: kStack entries in local memory.

namespace {

constexpr int kRayThreads = 128;  // rays a block
constexpr float kFar = 1e8f;      // geometry/bvh.py _FAR

__device__ __forceinline__ float inv_dir(float d) { return 1.f / (fabsf(d) < 1e-12f ? 1e-12f : d); }

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// the slab test of box (lo, hi) for the ray (o, inv): whether the ray meets
// it at t >= 0 and enters it before t_best; its entry distance in tn
__device__ __forceinline__ bool slab(V3 o, V3 inv, V3 lo, V3 hi, float t_best, float& tn) {
    const float t0x = (lo.x - o.x) * inv.x, t1x = (hi.x - o.x) * inv.x;
    const float t0y = (lo.y - o.y) * inv.y, t1y = (hi.y - o.y) * inv.y;
    const float t0z = (lo.z - o.z) * inv.z, t1z = (hi.z - o.z) * inv.z;
    tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fminf(t0z, t1z));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
    return tf >= fmaxf(tn, 0.f) && tn < t_best && lo.x <= hi.x;
}

// Moller-Trumbore on the triangle in packed slot s: its hit distance when
// the ray hits it strictly before `limit`, else +inf
__device__ __forceinline__ float tri_t(const float4* __restrict__ tris, V3 o, V3 d, long long s, float limit) {
    const float4 t0 = __ldg(tris + 3 * s), t1 = __ldg(tris + 3 * s + 1), t2 = __ldg(tris + 3 * s + 2);
    const V3 a{t0.x, t0.y, t0.z}, ab{t1.x, t1.y, t1.z}, ac{t2.x, t2.y, t2.z};
    const V3 pvec = cross(d, ac);
    const float det = dot(ab, pvec);
    const float inv_det = 1.f / (fabsf(det) < 1e-12f ? 1e-12f : det);
    const V3 tvec = sub(o, a);
    const float u = dot(tvec, pvec) * inv_det;
    const V3 qvec = cross(tvec, ab);
    const float v = dot(d, qvec) * inv_det;
    const float t = dot(ac, qvec) * inv_det;
    const bool ok = u >= 0.f && v >= 0.f && u + v <= 1.f && t > 1e-6f && t < limit;
    return ok ? t : __int_as_float(0x7f800000);
}

// the nearest hit before t_best among a leaf's triangles (link `code`) →
// its distance (+inf for none) in lt and its packed slot in ls; ties go to
// the lower slot
__device__ __forceinline__ void leaf_hit(const float4* __restrict__ tris, V3 o, V3 d, int code, float t_best,
                                         float& lt, int& ls) {
    const int start = (~code) >> 2, count = ((~code) & 3) + 1;
    lt = __int_as_float(0x7f800000);
    ls = start + kLeafSize;
    for (int k = 0; k < count; ++k) {
        const float t = tri_t(tris, o, d, (long long)start + k, fminf(lt, t_best));
        if (t < lt) lt = t, ls = start + k;
    }
}

__global__ void __launch_bounds__(kRayThreads)
bvh_ray_kernel(const BvhArgs b, const float* __restrict__ origins, const float* __restrict__ dirs,
               float* __restrict__ t_out, int* __restrict__ tri_out, int n) {
    int st_link[kStack];  // the farther children pushed, and their entry distances
    float st_t[kStack];
    const long long i = (long long)blockIdx.x * kRayThreads + threadIdx.x;
    if (i >= n) return;
    const V3 o = ld3(origins, i), d = ld3(dirs, i);
    const V3 inv{inv_dir(d.x), inv_dir(d.y), inv_dir(d.z)};
    float t_best = kFar;
    int best_slot = -1;
    int sp = 0;
    int node = 0;
    for (;;) {
        // visit inner record `node`: test both children
        const float4* r = b.nodes + 4LL * node;
        const float4 r0 = __ldg(r), r1 = __ldg(r + 1), r2 = __ldg(r + 2);
        const int4 r3 = __ldg(reinterpret_cast<const int4*>(r) + 3);
        float tl, tr;
        const bool hl = slab(o, inv, V3{r0.x, r0.y, r0.z}, V3{r0.w, r1.x, r1.y}, t_best, tl);
        const bool hr = slab(o, inv, V3{r1.z, r1.w, r2.x}, V3{r2.y, r2.z, r2.w}, t_best, tr);
        int next = 0;
        bool go = true;
        if (hl && hr) {
            const bool left_first = tl <= tr;
            next = left_first ? r3.x : r3.y;
            st_link[sp] = left_first ? r3.y : r3.x;
            st_t[sp] = left_first ? tr : tl;
            ++sp;
        } else if (hl) {
            next = r3.x;
        } else if (hr) {
            next = r3.y;
        } else {
            go = false;
        }
        // leaves, and pops, until the next inner record
        for (;;) {
            if (go) {
                if (next >= 0) break;
                float lt;
                int ls;
                leaf_hit(b.tris, o, d, next, t_best, lt, ls);
                if (lt < t_best) t_best = lt, best_slot = ls;
            }
            go = false;
            while (sp > 0) {
                --sp;
                if (st_t[sp] < t_best) {
                    next = st_link[sp];
                    go = true;
                    break;
                }
            }
            if (!go) break;
        }
        if (!go) break;
        node = next;
    }
    t_out[i] = t_best;
    tri_out[i] = best_slot < 0 ? -1 : __float_as_int(__ldg(&b.tris[3LL * best_slot].w));
}

}  // namespace

// t [n] f32 and tri [n] int32 from origins and directions [n, 3] f32 and the
// packed BVH *args (all on the device)
extern "C" int nst_bvh_ray(const BvhArgs* args, const void* origins, const void* directions, void* t_out,
                           void* tri_out, int n, void* stream) {
    if (args == nullptr || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const dim3 grid((unsigned)((n + kRayThreads - 1) / kRayThreads));
    bvh_ray_kernel<<<grid, kRayThreads, 0, (cudaStream_t)stream>>>(*args, (const float*)origins,
                                                                  (const float*)directions, (float*)t_out,
                                                                  (int*)tri_out, n);
    return (int)cudaGetLastError();
}
