// Native voxelizer for xlb_tpu.
//
// Host-side replacement for the reference's GPU mesh maskers (Warp BVH
// queries in xlb/operator/boundary_masker/{aabb,ray,winding}.py): voxelizes
// triangle soups into solid masks at setup time.  OpenMP-parallel, exposed
// to Python through ctypes (see __init__.py).
//
// Conventions match xlb_tpu.geometry.voxelize: voxel (i,j,k) has its center
// at origin + (ijk + 0.5) * spacing, and the RAY method counts +z ray
// crossings per (x,y) column (odd parity = inside).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// tris: (ntri, 3, 3) row-major xyz vertices.
// out:  (nx, ny, nz) uint8, preallocated and zeroed by the caller.
void voxelize_ray(const double* tris, int64_t ntri,
                  int64_t nx, int64_t ny, int64_t nz,
                  const double* origin, double spacing,
                  uint8_t* out) {
    // Precompute per-triangle 2D (x,y) data.
    std::vector<double> ax(ntri), ay(ntri), az(ntri);
    std::vector<double> d00(ntri), d01(ntri), d10(ntri), d11(ntri);
    std::vector<double> bz(ntri), cz(ntri);
    std::vector<double> xmin(ntri), xmax(ntri), ymin(ntri), ymax(ntri);
    for (int64_t t = 0; t < ntri; ++t) {
        const double* v0 = tris + 9 * t;
        const double* v1 = v0 + 3;
        const double* v2 = v0 + 6;
        ax[t] = v0[0]; ay[t] = v0[1]; az[t] = v0[2];
        d00[t] = v1[0] - v0[0]; d01[t] = v1[1] - v0[1];
        d10[t] = v2[0] - v0[0]; d11[t] = v2[1] - v0[1];
        bz[t] = v1[2] - v0[2];  cz[t] = v2[2] - v0[2];
        xmin[t] = std::fmin(v0[0], std::fmin(v1[0], v2[0]));
        xmax[t] = std::fmax(v0[0], std::fmax(v1[0], v2[0]));
        ymin[t] = std::fmin(v0[1], std::fmin(v1[1], v2[1]));
        ymax[t] = std::fmax(v0[1], std::fmax(v1[1], v2[1]));
    }

#pragma omp parallel for schedule(dynamic)
    for (int64_t ix = 0; ix < nx; ++ix) {
        const double x = origin[0] + (ix + 0.5) * spacing;
        std::vector<int32_t> crossings(ny * nz, 0);
        for (int64_t t = 0; t < ntri; ++t) {
            if (x < xmin[t] || x > xmax[t]) continue;
            const double det = d00[t] * d11[t] - d10[t] * d01[t];
            if (std::fabs(det) < 1e-30) continue;
            const double px = x - ax[t];
            // y bounds of this triangle restricted to the column range
            int64_t jlo = (int64_t)std::floor((ymin[t] - origin[1]) / spacing - 0.5);
            int64_t jhi = (int64_t)std::ceil((ymax[t] - origin[1]) / spacing - 0.5);
            if (jlo < 0) jlo = 0;
            if (jhi > ny - 1) jhi = ny - 1;
            for (int64_t iy = jlo; iy <= jhi; ++iy) {
                const double y = origin[1] + (iy + 0.5) * spacing;
                const double py = y - ay[t];
                const double w1 = (px * d11[t] - py * d10[t]) / det;
                const double w2 = (py * d00[t] - px * d01[t]) / det;
                if (w1 < 0.0 || w2 < 0.0 || w1 + w2 > 1.0) continue;
                const double zhit = az[t] + w1 * bz[t] + w2 * cz[t];
                // toggle all voxel centers above zhit
                int64_t kstart = (int64_t)std::ceil((zhit - origin[2]) / spacing - 0.5);
                if (kstart < 0) kstart = 0;
                for (int64_t iz = kstart; iz < nz; ++iz) {
                    crossings[iy * nz + iz] += 1;
                }
            }
        }
        uint8_t* slab = out + ix * ny * nz;
        for (int64_t i = 0; i < ny * nz; ++i) slab[i] |= (uint8_t)(crossings[i] & 1);
    }
}

// Generalized winding number (van Oosterom & Strackee solid angles).
// points: (npts, 3); out: (npts,) double winding numbers.
void winding_numbers(const double* tris, int64_t ntri,
                     const double* points, int64_t npts,
                     double* out) {
#pragma omp parallel for schedule(static)
    for (int64_t p = 0; p < npts; ++p) {
        const double qx = points[3 * p], qy = points[3 * p + 1], qz = points[3 * p + 2];
        double total = 0.0;
        for (int64_t t = 0; t < ntri; ++t) {
            const double* v = tris + 9 * t;
            const double a0 = v[0] - qx, a1 = v[1] - qy, a2 = v[2] - qz;
            const double b0 = v[3] - qx, b1 = v[4] - qy, b2 = v[5] - qz;
            const double c0 = v[6] - qx, c1 = v[7] - qy, c2 = v[8] - qz;
            const double la = std::sqrt(a0 * a0 + a1 * a1 + a2 * a2);
            const double lb = std::sqrt(b0 * b0 + b1 * b1 + b2 * b2);
            const double lc = std::sqrt(c0 * c0 + c1 * c1 + c2 * c2);
            const double cbx = b1 * c2 - b2 * c1;
            const double cby = b2 * c0 - b0 * c2;
            const double cbz = b0 * c1 - b1 * c0;
            const double numer = a0 * cbx + a1 * cby + a2 * cbz;
            const double denom = la * lb * lc + (a0 * b0 + a1 * b1 + a2 * b2) * lc +
                                 (b0 * c0 + b1 * c1 + b2 * c2) * la +
                                 (c0 * a0 + c1 * a1 + c2 * a2) * lb;
            total += 2.0 * std::atan2(numer, denom);
        }
        out[p] = total / (4.0 * M_PI);
    }
}

// Conservative triangle shell: mark voxels whose unit cell the triangle's
// (recursively subdivided) AABB touches.
static void shell_rec(const double* v0, const double* v1, const double* v2,
                      int64_t nx, int64_t ny, int64_t nz,
                      const double* origin, double spacing,
                      uint8_t* out, int depth) {
    double lo[3], hi[3];
    for (int d = 0; d < 3; ++d) {
        lo[d] = std::fmin(v0[d], std::fmin(v1[d], v2[d]));
        hi[d] = std::fmax(v0[d], std::fmax(v1[d], v2[d]));
    }
    int64_t il[3], ih[3];
    int64_t dims[3] = {nx, ny, nz};
    int64_t span = 0;
    for (int d = 0; d < 3; ++d) {
        il[d] = (int64_t)std::floor((lo[d] - origin[d]) / spacing);
        ih[d] = (int64_t)std::floor((hi[d] - origin[d]) / spacing);
        if (il[d] < 0) il[d] = 0;
        if (ih[d] > dims[d] - 1) ih[d] = dims[d] - 1;
        if (ih[d] - il[d] > span) span = ih[d] - il[d];
    }
    if (span <= 1 || depth > 16) {
        for (int64_t i = il[0]; i <= ih[0]; ++i)
            for (int64_t j = il[1]; j <= ih[1]; ++j)
                for (int64_t k = il[2]; k <= ih[2]; ++k)
                    out[(i * ny + j) * nz + k] = 1;
        return;
    }
    double m01[3], m12[3], m20[3];
    for (int d = 0; d < 3; ++d) {
        m01[d] = 0.5 * (v0[d] + v1[d]);
        m12[d] = 0.5 * (v1[d] + v2[d]);
        m20[d] = 0.5 * (v2[d] + v0[d]);
    }
    shell_rec(v0, m01, m20, nx, ny, nz, origin, spacing, out, depth + 1);
    shell_rec(v1, m12, m01, nx, ny, nz, origin, spacing, out, depth + 1);
    shell_rec(v2, m20, m12, nx, ny, nz, origin, spacing, out, depth + 1);
    shell_rec(m01, m12, m20, nx, ny, nz, origin, spacing, out, depth + 1);
}

void triangle_shell(const double* tris, int64_t ntri,
                    int64_t nx, int64_t ny, int64_t nz,
                    const double* origin, double spacing,
                    uint8_t* out) {
#pragma omp parallel for schedule(dynamic)
    for (int64_t t = 0; t < ntri; ++t) {
        const double* v = tris + 9 * t;
        shell_rec(v, v + 3, v + 6, nx, ny, nz, origin, spacing, out, 0);
    }
}


// Moller-Trumbore directional wall distances for HybridBC curved
// boundaries (xlb_tpu/geometry/distances.py fast path; same tolerances
// as the NumPy implementation).  voxels: (n, 3) ray origins; dirs:
// (q, 3) lattice directions (unnormalized); out: (q, n) normalized
// hit parameter (t / |c|, +inf when the link misses every triangle).
void directional_distances(const double* tris, int64_t ntri,
                           const double* voxels, int64_t n,
                           const double* dirs, int64_t q,
                           double* out) {
    const double INF = 1.0 / 0.0;
    // precompute per-triangle edges
    std::vector<double> e1(3 * ntri), e2(3 * ntri);
    for (int64_t m = 0; m < ntri; ++m) {
        const double* v = tris + 9 * m;
        for (int k = 0; k < 3; ++k) {
            e1[3 * m + k] = v[3 + k] - v[k];
            e2[3 * m + k] = v[6 + k] - v[k];
        }
    }
#pragma omp parallel for schedule(dynamic)
    for (int64_t l = 0; l < q; ++l) {
        const double* dv = dirs + 3 * l;
        const double nrm = std::sqrt(dv[0] * dv[0] + dv[1] * dv[1] + dv[2] * dv[2]);
        if (nrm == 0.0) {
            for (int64_t i = 0; i < n; ++i) out[l * n + i] = INF;
            continue;
        }
        const double d0 = dv[0] / nrm, d1 = dv[1] / nrm, d2 = dv[2] / nrm;
        // per-(direction, triangle) constants: p = d x e2, det = e1 . p
        std::vector<double> px(ntri), py(ntri), pz(ntri), inv_det(ntri);
        std::vector<uint8_t> valid(ntri);
        for (int64_t m = 0; m < ntri; ++m) {
            const double* E2 = e2.data() + 3 * m;
            const double* E1 = e1.data() + 3 * m;
            const double cx = d1 * E2[2] - d2 * E2[1];
            const double cy = d2 * E2[0] - d0 * E2[2];
            const double cz = d0 * E2[1] - d1 * E2[0];
            const double det = E1[0] * cx + E1[1] * cy + E1[2] * cz;
            px[m] = cx; py[m] = cy; pz[m] = cz;
            valid[m] = std::fabs(det) > 1e-12;
            inv_det[m] = valid[m] ? 1.0 / det : 0.0;
        }
        for (int64_t i = 0; i < n; ++i) {
            const double* o = voxels + 3 * i;
            double tmin = INF;
            for (int64_t m = 0; m < ntri; ++m) {
                if (!valid[m]) continue;
                const double* v0 = tris + 9 * m;
                const double tvx = o[0] - v0[0], tvy = o[1] - v0[1], tvz = o[2] - v0[2];
                const double u = (tvx * px[m] + tvy * py[m] + tvz * pz[m]) * inv_det[m];
                if (u < -1e-9) continue;
                const double* E1 = e1.data() + 3 * m;
                const double qx = tvy * E1[2] - tvz * E1[1];
                const double qy = tvz * E1[0] - tvx * E1[2];
                const double qz = tvx * E1[1] - tvy * E1[0];
                const double vv = (qx * d0 + qy * d1 + qz * d2) * inv_det[m];
                if (vv < -1e-9 || u + vv > 1.0 + 1e-9) continue;
                const double* E2 = e2.data() + 3 * m;
                const double t = (qx * E2[0] + qy * E2[1] + qz * E2[2]) * inv_det[m];
                if (t > 1e-12 && t < tmin) tmin = t;
            }
            out[l * n + i] = tmin / nrm;
        }
    }
}

}  // extern "C"
