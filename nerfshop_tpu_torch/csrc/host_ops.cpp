// The port's native host library (C++17, std::thread), bound with ctypes by
// nerfshop_tpu_torch/native.py, which builds it with g++ at first use.
//
// The host-heavy stages of an interactive edit: the per-drag tet-grid
// voxelization of the cage's LUTs, the region-growing flood fill over one
// density cascade, and the cell clearing of "vanish". A copy of
// nerfshop_tpu/native/host_ops.cpp: everything from the first include line on is
// the original's text (tests/test_torch_host_copies.py holds it so).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Tet voxelization: conservative bbox overlap of each tet against a res³
// uniform grid, fixed fanout per cell (max_t tet ids, -1 padded).
// Returns the max fanout actually seen (may exceed max_t → truncated).
// ---------------------------------------------------------------------------
int voxelize_tets(
    const float* verts,      // [n_verts, 3]
    const int32_t* tets,     // [n_tets, 4]
    int64_t n_tets,
    int res,
    const float* bbox_lo,    // [3]
    const float* inv_cell,   // [3] = res / (hi - lo)
    int max_t,
    int32_t* cells_out       // [res^3, max_t], prefilled with -1
) {
    const int64_t n_cells = (int64_t)res * res * res;
    std::vector<std::atomic<int32_t>> counts(n_cells);
    for (auto& c : counts) c.store(0, std::memory_order_relaxed);

    const unsigned n_threads = std::max(1u, std::thread::hardware_concurrency());
    std::atomic<int32_t> overflow{0};

    // cell geometry (double, mirroring the numpy reference in
    // tet_mesh.py::_voxelize so native and python produce identical lists)
    double cell_size[3], half_abs[3];
    for (int a = 0; a < 3; ++a) {
        cell_size[a] = 1.0 / (double)inv_cell[a];
        half_abs[a] = cell_size[a] * 0.5;
    }
    const double margin = std::sqrt(cell_size[0] * cell_size[0] +
                                    cell_size[1] * cell_size[1] +
                                    cell_size[2] * cell_size[2]);

    auto worker = [&](int64_t begin, int64_t end) {
        for (int64_t ti = begin; ti < end; ++ti) {
            const float* tv[4];
            float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
            for (int k = 0; k < 4; ++k) {
                tv[k] = verts + 3 * (int64_t)tets[4 * ti + k];
                for (int a = 0; a < 3; ++a) {
                    lo[a] = std::min(lo[a], tv[k][a]);
                    hi[a] = std::max(hi[a], tv[k][a]);
                }
            }
            int c0[3], c1[3];
            // pad by one cell: neighboring cells keep the tet as a warp
            // candidate so hairline non-conformity at concave cage creases
            // can resolve via near-miss barycentric fallback
            for (int a = 0; a < 3; ++a) {
                c0[a] = std::clamp((int)((lo[a] - bbox_lo[a]) * inv_cell[a]) - 1, 0, res - 1);
                c1[a] = std::clamp((int)((hi[a] - bbox_lo[a]) * inv_cell[a]) + 1, 0, res - 1);
            }
            // outward face planes (face f opposite vertex f) — computed in
            // f32 like numpy (cross/einsum of f32 verts stay f32 there),
            // plane TEST in double like numpy's f64 cell centers. A cell
            // entirely outside any face plane beyond the near-miss margin
            // cannot contain (or nearly contain) a tet point; bbox-only
            // voxelization lists 100+ tets per cell under sliver tets.
            static const int F[4][3] = {{1, 2, 3}, {0, 3, 2}, {0, 1, 3}, {0, 2, 1}};
            float n[4][3], dpl[4];
            double slack[4];
            for (int f = 0; f < 4; ++f) {
                const float* A = tv[F[f][0]];
                const float* B = tv[F[f][1]];
                const float* C = tv[F[f][2]];
                float e1[3], e2[3];
                for (int a = 0; a < 3; ++a) { e1[a] = B[a] - A[a]; e2[a] = C[a] - A[a]; }
                n[f][0] = e1[1] * e2[2] - e1[2] * e2[1];
                n[f][1] = e1[2] * e2[0] - e1[0] * e2[2];
                n[f][2] = e1[0] * e2[1] - e1[1] * e2[0];
                const float* opp = tv[f];
                float dot = 0.f;
                for (int a = 0; a < 3; ++a) dot += n[f][a] * (opp[a] - A[a]);
                if (dot > 0.f)
                    for (int a = 0; a < 3; ++a) n[f][a] = -n[f][a];
                dpl[f] = n[f][0] * A[0] + n[f][1] * A[1] + n[f][2] * A[2];
                double nrm = std::sqrt((double)n[f][0] * n[f][0] +
                                       (double)n[f][1] * n[f][1] +
                                       (double)n[f][2] * n[f][2]);
                slack[f] = std::abs((double)n[f][0]) * half_abs[0] +
                           std::abs((double)n[f][1]) * half_abs[1] +
                           std::abs((double)n[f][2]) * half_abs[2] + margin * nrm;
            }
            for (int x = c0[0]; x <= c1[0]; ++x) {
                double cx = (x + 0.5) * cell_size[0] + (double)bbox_lo[0];
                for (int y = c0[1]; y <= c1[1]; ++y) {
                    double cy = (y + 0.5) * cell_size[1] + (double)bbox_lo[1];
                    for (int z = c0[2]; z <= c1[2]; ++z) {
                        double cz = (z + 0.5) * cell_size[2] + (double)bbox_lo[2];
                        bool keep = true;
                        for (int f = 0; f < 4 && keep; ++f) {
                            double proj = cx * (double)n[f][0] + cy * (double)n[f][1] +
                                          cz * (double)n[f][2];
                            keep = proj - slack[f] <= (double)dpl[f];
                        }
                        if (!keep) continue;
                        int64_t ci = ((int64_t)x * res + y) * res + z;
                        int32_t slot = counts[ci].fetch_add(1, std::memory_order_relaxed);
                        if (slot < max_t)
                            cells_out[ci * max_t + slot] = (int32_t)ti;
                        else
                            overflow.store(slot + 1, std::memory_order_relaxed);
                    }
                }
            }
        }
    };

    std::vector<std::thread> pool;
    int64_t chunk = (n_tets + n_threads - 1) / n_threads;
    for (unsigned t = 0; t < n_threads; ++t) {
        int64_t b = t * chunk, e = std::min<int64_t>(n_tets, b + chunk);
        if (b < e) pool.emplace_back(worker, b, e);
    }
    for (auto& th : pool) th.join();

    // deterministic per-cell order (ascending tet id, matching the python
    // reference's sequential append) regardless of thread interleaving
    int32_t max_seen = overflow.load();
    for (int64_t ci = 0; ci < n_cells; ++ci) {
        int32_t cnt = std::min(counts[ci].load(std::memory_order_relaxed), max_t);
        std::sort(cells_out + ci * max_t, cells_out + ci * max_t + cnt);
        max_seen = std::max(max_seen, counts[ci].load(std::memory_order_relaxed));
    }
    return max_seen;
}

// ---------------------------------------------------------------------------
// Region growing: BFS flood fill over one 128³ density cascade
// (accept if density >= threshold; 6-connected). In-place on `selection`
// (uint8 0/1). Seeds: flat indices. Returns #accepted.
// ---------------------------------------------------------------------------
int64_t region_grow(
    const float* density,    // [res^3]
    uint8_t* selection,      // [res^3] in/out
    int res,
    const int32_t* seeds,    // [n_seeds]
    int64_t n_seeds,
    float threshold,
    int64_t max_steps
) {
    std::deque<int32_t> queue(seeds, seeds + n_seeds);
    std::vector<uint8_t> queued((size_t)res * res * res, 0);
    for (int64_t i = 0; i < n_seeds; ++i) queued[seeds[i]] = 1;
    int64_t grown = 0, steps = 0;
    const int32_t r2 = res * res;
    while (!queue.empty() && steps < max_steps) {
        ++steps;
        int32_t c = queue.front();
        queue.pop_front();
        if (selection[c]) continue;
        if (density[c] < threshold) continue;
        selection[c] = 1;
        ++grown;
        int32_t x = c / r2, y = (c / res) % res, z = c % res;
        const int32_t nb[6] = {
            x > 0 ? c - r2 : -1, x < res - 1 ? c + r2 : -1,
            y > 0 ? c - res : -1, y < res - 1 ? c + res : -1,
            z > 0 ? c - 1 : -1, z < res - 1 ? c + 1 : -1,
        };
        for (int k = 0; k < 6; ++k)
            if (nb[k] >= 0 && !queued[nb[k]] && !selection[nb[k]]) {
                queued[nb[k]] = 1;
                queue.push_back(nb[k]);
            }
    }
    return grown;
}

// ---------------------------------------------------------------------------
// Vanish: zero grid cells whose center lies inside any tet's bbox
// (TetMesh::vanish tet_mesh.cu:251-363, threaded).
// ---------------------------------------------------------------------------
void clear_cells_in_tets(
    const float* verts, const int32_t* tets, int64_t n_tets,
    int res, float world_lo, float cell_w,
    float* density /* [res^3] in/out */
) {
    const unsigned n_threads = std::max(1u, std::thread::hardware_concurrency());
    auto worker = [&](int64_t begin, int64_t end) {
        for (int64_t ti = begin; ti < end; ++ti) {
            float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
            for (int k = 0; k < 4; ++k) {
                const float* v = verts + 3 * (int64_t)tets[4 * ti + k];
                for (int a = 0; a < 3; ++a) {
                    lo[a] = std::min(lo[a], v[a]);
                    hi[a] = std::max(hi[a], v[a]);
                }
            }
            int c0[3], c1[3];
            for (int a = 0; a < 3; ++a) {
                c0[a] = std::clamp((int)((lo[a] - world_lo) / cell_w) - 1, 0, res - 1);
                c1[a] = std::clamp((int)((hi[a] - world_lo) / cell_w) + 1, 0, res - 1);
            }
            for (int x = c0[0]; x <= c1[0]; ++x)
                for (int y = c0[1]; y <= c1[1]; ++y)
                    for (int z = c0[2]; z <= c1[2]; ++z)
                        density[((int64_t)x * res + y) * res + z] = 0.0f;
        }
    };
    std::vector<std::thread> pool;
    int64_t chunk = (n_tets + n_threads - 1) / n_threads;
    for (unsigned t = 0; t < n_threads; ++t) {
        int64_t b = t * chunk, e = std::min<int64_t>(n_tets, b + chunk);
        if (b < e) pool.emplace_back(worker, b, e);
    }
    for (auto& th : pool) th.join();
}

}  // extern "C"
