// P1: the eight-point two-view pose of B frame pairs in one launch and, in
// its bootstrap instance, the rest of each pair's two-view bootstrap
// (ops/kernels/epipolar_kernel.py, whose module docstring gives the steps;
// its plain versions, estimate_transform_batched_plain and
// bootstrap_batched_plain, repeat this arithmetic op for op and in the same
// order).
//
// Replaces no TPU kernel: the JAX package computes these steps with XLA
// (visual_odometry_tpu/ops/epipolar.py:estimate_transform and
// models/pipeline.py:initialize, vmapped by its batched programs). It exists
// so that a pair's results have the same bits alone and in any batch (the
// card's batched library solvers pick their algorithm by the batch's size),
// and so that the bootstrap after the match is one launch with no host sync
// in place of ~100 small PyTorch operations and seven boolean indexings.
//
// Design: one CTA of 256 threads a pair, the pose's arithmetic in float64
// from the float32 inputs, rounded to float32 once at the end.
// - Masked maxima: the CTA strides over the slots (a maximum is order-free).
// - The 45 normal-matrix sums: a chunk of 256 correspondences at a time, each
//   thread forms one design row into shared memory, then warp w adds entries
//   w, w + 8, ... of the chunk's rows. Each entry keeps one order:
//   correspondence s on lane s % 32 at step s / 32, serial from 0.0, then the
//   shuffle-down tree 16, 8, 4, 2, 1.
// - The cyclic Jacobi of the 9x9 runs on warp 0 in shared memory (every lane
//   computes the rotation, lane j updates rows j of A and V, lanes p and q
//   the pivot's entries, with no divergent branch): its pivot order is the
//   pose's bits, and a rotation's chain of 4 divides and 2 square roots is
//   its time. A form that splits the update into three divergent branches
//   (A's rows, V's rows, the pivot) takes 17% more cycles a rotation; forms
//   that hold the 9x9 in every lane's registers, or rows in lanes'
//   registers exchanged by shuffles, issue more work on that one warp and
//   take 25-41% more than that (PERF.md). The LU, the inverse iterations and
//   the two 3x3 SVDs run on thread 0, for the same reason.
// - The cheirality votes of the four candidates over the S correspondences
//   on the whole CTA: integer counts, so their order is free.
// - The bootstrap instance (SEED): thread 0 planarizes the pose (a mount
//   given) and forms its inverse and the triangulation's matrices; then one
//   slot a thread triangulates (float32 rays, the 2x2 mid-point system in
//   float64), a block-wide exclusive scan of the valid slots in slot order
//   compacts them into the seeded map (truncated at its capacity,
//   appearances from the second frame), and a shared-memory table of
//   atomicMin over the live slots gives each second-frame measurement its
//   first slot (-1 where none).
// Bound: at the pipeline's shapes (64 pairs x 128 correspondences, or one
// pair x 1,024) the work is a few hundred thousand operations and a few
// hundred KB to a few MB, far below one launch; the kernel's time is its
// serial chain (Jacobi rotations, float64 divides and square roots).
#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int JACOBI_SWEEPS = 50;
constexpr int JACOBI_ZERO_FROM = 4;
constexpr int SVD3_SWEEPS = 16;
constexpr double SVD3_TOL = 0x1p-50;
constexpr int INVERSE_ITERATIONS = 3;
constexpr double DET_EPS = 1e-12;   // ops/triangulation._DET_EPS
constexpr int NO_SLOT = 0x7fffffff;

// Row and column of normal-matrix entry k (row-major upper triangle).
__constant__ unsigned char PAIR_X[45] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1,
                                         1, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 4, 4,
                                         4, 4, 4, 5, 5, 5, 5, 6, 6, 6, 7, 7, 8};
__constant__ unsigned char PAIR_Y[45] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 4, 5, 6, 7,
                                         8, 2, 3, 4, 5, 6, 7, 8, 3, 4, 5, 6, 7, 8, 4, 5,
                                         6, 7, 8, 5, 6, 7, 8, 6, 7, 8, 7, 8, 8};

// Cycle stamps of a pair's phases, compiled only into the diagnostic builds
// of chip_ab.py (-DVO_P1_PHASES): thread 0 adds each phase's clock64() cycles
// to vo_p1_phase_cycles. Slots: 0 masked maxima, 1 normal-matrix sums, 2
// Jacobi, 3 LU and inverse iterations, 4 the two 3x3 SVDs and the
// candidates, 5 votes, 6 seed, 7 pose and output stores; 15 pairs.
#ifdef VO_P1_PHASES
__device__ unsigned long long vo_p1_phase_cycles[16];
#define P1_STAMPS long long p1_last = clock64()
#define P1_PHASE(slot)                                                                   \
  if (threadIdx.x == 0) {                                                                \
    const long long p1_now = clock64();                                                  \
    atomicAdd(&vo_p1_phase_cycles[slot], static_cast<unsigned long long>(p1_now - p1_last)); \
    p1_last = p1_now;                                                                    \
  }
#else
#define P1_STAMPS
#define P1_PHASE(slot)
#endif

// The planar mount (4 x 4, row-major) by value; planar = 0 skips the
// projection.
struct Mount {
    float m[16];
    int planar;
};

// Elements from one pair's frame rows to the next: the points (N, 2), the
// masks (N,) and the second frame's appearances (N, D) of a pair lie
// contiguous, the pairs anywhere (a frame of a (B, F, ...) stack).
struct PairStrides {
    long long p1, p2, mask1, mask2, apps2;
};

__device__ __forceinline__ double nan_max(double a, double b) {
    return (b > a || isnan(b)) ? b : a;
}

__device__ __forceinline__ double dot3(const double* a, const double* b) {
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// (a b)[i][j] = (a_i0 b_0j + a_i1 b_1j) + a_i2 b_2j, row-major 3x3.
__device__ void mul3(const double* a, const double* b, double* out) {
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            out[3 * i + j] = (a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j]) + a[3 * i + 2] * b[6 + j];
}

__device__ void transpose3(const double* a, double* out) {
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) out[3 * i + j] = a[3 * j + i];
}

// K^-1 by the adjugate over the determinant (triangulation.inv3_elementwise).
__device__ void inv3(const float* kmat, double* ik) {
    double m[9];
    for (int i = 0; i < 9; ++i) m[i] = kmat[i];
    const double c[3][3] = {
        {m[4] * m[8] - m[5] * m[7], m[5] * m[6] - m[3] * m[8], m[3] * m[7] - m[4] * m[6]},
        {m[2] * m[7] - m[1] * m[8], m[0] * m[8] - m[2] * m[6], m[1] * m[6] - m[0] * m[7]},
        {m[1] * m[5] - m[2] * m[4], m[2] * m[3] - m[0] * m[5], m[0] * m[4] - m[1] * m[3]}};
    const double kdet = (m[0] * c[0][0] + m[1] * c[0][1]) + m[2] * c[0][2];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) ik[3 * i + j] = c[j][i] / kdet;
}

// ((a_i0 b_0j + a_i1 b_1j) + a_i2 b_2j) + a_i3 b_3j, row-major 4x4 float32
// (se3.matmul_elementwise).
__device__ void mul4f(const float* a, const float* b, float* out) {
    for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j)
            out[4 * i + j] = ((a[4 * i] * b[j] + a[4 * i + 1] * b[4 + j]) + a[4 * i + 2] * b[8 + j]) +
                             a[4 * i + 3] * b[12 + j];
}

// [R^T | -((R_0j t_0 + R_1j t_1) + R_2j t_2)] (se3.inverse_elementwise).
__device__ void inverse4f(const float* x, float* out) {
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) out[4 * i + j] = x[4 * j + i];
        out[4 * i + 3] = -((x[i] * x[3] + x[4 + i] * x[7]) + x[8 + i] * x[11]);
        out[12 + i] = 0.0f;
    }
    out[15] = 1.0f;
}

// The yaw of the rotation's first column and the x, y translation
// (se3.project_se2_elementwise).
__device__ void project_se2f(const float* p, float* out) {
    const float x = p[0], y = p[4];
    const float r = sqrtf(x * x + y * y);
    const bool live = r > 0.0f;
    const float safe = live ? r : 1.0f;
    const float c = live ? x / safe : 1.0f;
    const float s = live ? y / safe : 0.0f;
    const float rows[16] = {c, -s, 0.0f, p[3], s, c, 0.0f, p[7],
                            0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f};
    for (int i = 0; i < 16; ++i) out[i] = rows[i];
}

// One-sided Jacobi: col[c][r] holds column c of m V, vcol[c][r] column c of V.
__device__ void svd3_columns(const double* m, double col[3][3], double vcol[3][3]) {
    for (int c = 0; c < 3; ++c)
        for (int r = 0; r < 3; ++r) {
            col[c][r] = m[3 * r + c];
            vcol[c][r] = (r == c) ? 1.0 : 0.0;
        }
    const int pi[3] = {0, 0, 1}, pj[3] = {1, 2, 2};
    for (int sweep = 0; sweep < SVD3_SWEEPS; ++sweep) {
        bool turned = false;
        for (int k = 0; k < 3; ++k) {
            const int i = pi[k], j = pj[k];
            const double alpha = dot3(col[i], col[i]);
            const double beta = dot3(col[j], col[j]);
            const double gamma = dot3(col[i], col[j]);
            if (!(fabs(gamma) > SVD3_TOL * sqrt(alpha * beta))) continue;
            const double zeta = (beta - alpha) / (2.0 * gamma);
            double t = 1.0 / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
            if (zeta < 0.0) t = -t;
            const double c = 1.0 / sqrt(1.0 + t * t);
            const double s = c * t;
            for (int r = 0; r < 3; ++r) {
                const double x = col[i][r], y = col[j][r];
                col[i][r] = c * x - s * y;
                col[j][r] = s * x + c * y;
                const double vx = vcol[i][r], vy = vcol[j][r];
                vcol[i][r] = c * vx - s * vy;
                vcol[j][r] = s * vx + c * vy;
            }
            turned = true;
        }
        if (!turned) break;
    }
}

// (first, second, last) columns by descending squared norm: the last is the
// smallest (the higher index on a tie, a NaN norm counting as -1), the other
// two in index order unless the second is larger.
__device__ void order3(double col[3][3], int* first, int* second, int* last) {
    double n[3];
    for (int c = 0; c < 3; ++c) {
        const double q = dot3(col[c], col[c]);
        n[c] = isnan(q) ? -1.0 : q;
    }
    int l = 2;
    double best = n[2];
    for (int i = 1; i >= 0; --i)
        if (n[i] < best) {
            best = n[i];
            l = i;
        }
    const int a = (l == 0) ? 1 : 0;
    const int b = (l == 2) ? 1 : 2;
    const bool swap = n[b] > n[a];
    *first = swap ? b : a;
    *second = swap ? a : b;
    *last = l;
}

// The cyclic Jacobi of the symmetric A0 (module docstring step 3) on one warp,
// A and V in shared memory: every lane computes the rotation, lane j < 9
// updates row j of A (and its transpose) and row j of V in one stream, lanes
// p and q write the pivot's entries; no branch diverges. The diagonal form
// is left in A, the eigenvectors in V's columns.
__device__ void jacobi(const double A0[9][9], double A[9][9], double V[9][9], int lane) {
    if (lane < 9)
        for (int j = 0; j < 9; ++j) {
            A[lane][j] = A0[lane][j];
            V[lane][j] = (j == lane) ? 1.0 : 0.0;
        }
    __syncwarp();
    const int row = (lane < 9) ? lane : 0;
    for (int sweep = 0; sweep < JACOBI_SWEEPS; ++sweep) {
        bool nz = false;
        if (lane < 9)
            for (int j = 0; j < 9; ++j) nz = nz || (j != lane && A[lane][j] != 0.0);
        if (!__any_sync(FULL, nz)) break;
        for (int p = 0; p < 8; ++p)
            for (int q = p + 1; q < 9; ++q) {
                const double apq = A[p][q], app = A[p][p], aqq = A[q][q];
                const double gp = A[row][p], hq = A[row][q];
                const double vp = V[row][p], vq = V[row][q];
                __syncwarp();
                const double g = 100.0 * fabs(apq);
                const bool drop = sweep >= JACOBI_ZERO_FROM && fabs(app) + g == fabs(app) &&
                                  fabs(aqq) + g == fabs(aqq);
                if (drop) {
                    if (lane == 0) {
                        A[p][q] = 0.0;
                        A[q][p] = 0.0;
                    }
                } else if (apq != 0.0) {
                    const double h = aqq - app;
                    double t;
                    if (fabs(h) + g == fabs(h)) {
                        t = apq / h;
                    } else {
                        const double theta = 0.5 * h / apq;
                        t = 1.0 / (fabs(theta) + sqrt(1.0 + theta * theta));
                        if (theta < 0.0) t = -t;
                    }
                    const double c = 1.0 / sqrt(1.0 + t * t);
                    const double s = t * c;
                    const double tau = s / (1.0 + c);
                    const double hh = t * apq;
                    const double np = gp - s * (hq + gp * tau);
                    const double nq = hq + s * (gp - hq * tau);
                    const double nvp = vp - s * (vq + vp * tau);
                    const double nvq = vq + s * (vp - vq * tau);
                    if (lane < 9) {
                        // Lane p writes A[p][p] and A[p][q], lane q A[q][q] and
                        // A[q][p]; every other lane its entries (j, p), (j, q)
                        // and their transposes.
                        const bool at_p = lane == p, at_q = lane == q;
                        const int c1 = (at_p || at_q) ? lane : p;
                        const int c2 = at_q ? p : q;
                        const double v1 = at_p ? app - hh : (at_q ? aqq + hh : np);
                        const double v2 = (at_p || at_q) ? 0.0 : nq;
                        A[lane][c1] = v1;
                        A[c1][lane] = v1;
                        A[lane][c2] = v2;
                        A[c2][lane] = v2;
                        V[lane][p] = nvp;
                        V[lane][q] = nvq;
                    }
                }
                __syncwarp();
            }
    }
}

// The unit null vector f of the normal matrix A0 from its Jacobi form A, V
// (module docstring step 3), on one thread.
__device__ void null_vector(const double A0[9][9], const double A[9][9], const double V[9][9],
                            double* f) {
    int kmin = 0;
    double best = A[0][0];
    for (int i = 1; i < 9; ++i) {
        const double d = A[i][i];
        if (d < best || (isnan(d) && !isnan(best))) {
            best = d;
            kmin = i;
        }
    }
    double v0[9], v[9];
    for (int i = 0; i < 9; ++i) v0[i] = V[i][kmin];

    double tr = A0[0][0];
    for (int i = 1; i < 9; ++i) tr = tr + A0[i][i];
    const double ridge = 1e-6 * tr;
    double M[9][9];
    for (int i = 0; i < 9; ++i)
        for (int j = 0; j < 9; ++j) M[i][j] = (i == j) ? A0[i][i] + ridge : A0[i][j];
    int piv[9];
    bool singular = false;
    for (int k = 0; k < 9; ++k) {
        double big = fabs(M[k][k]);
        int pk = k;
        for (int i = k + 1; i < 9; ++i) {
            const double a = fabs(M[i][k]);
            if (a > big || (isnan(a) && !isnan(big))) {
                big = a;
                pk = i;
            }
        }
        if (pk != k)
            for (int j = 0; j < 9; ++j) {
                const double tmp = M[k][j];
                M[k][j] = M[pk][j];
                M[pk][j] = tmp;
            }
        piv[k] = pk;
        singular = singular || M[k][k] == 0.0;
        for (int i = k + 1; i < 9; ++i) {
            const double l = M[i][k] / M[k][k];
            M[i][k] = l;
            for (int j = k + 1; j < 9; ++j) M[i][j] = M[i][j] - l * M[k][j];
        }
    }
    bool finite = !singular;
    for (int i = 0; i < 9; ++i) v[i] = v0[i];
    for (int it = 0; it < INVERSE_ITERATIONS && finite; ++it) {
        double x[9];
        for (int i = 0; i < 9; ++i) x[i] = v[i];
        for (int k = 0; k < 9; ++k) {
            const double tmp = x[k];
            x[k] = x[piv[k]];
            x[piv[k]] = tmp;
        }
        for (int i = 1; i < 9; ++i)
            for (int j = 0; j < i; ++j) x[i] = x[i] - M[i][j] * x[j];
        for (int i = 8; i >= 0; --i) {
            for (int j = i + 1; j < 9; ++j) x[i] = x[i] - M[i][j] * x[j];
            x[i] = x[i] / M[i][i];
        }
        double sq = x[0] * x[0];
        for (int i = 1; i < 9; ++i) sq = sq + x[i] * x[i];
        double nrm = sqrt(sq);
        nrm = (nrm < 1e-30) ? 1e-30 : nrm;
        for (int i = 0; i < 9; ++i) v[i] = x[i] / nrm;
    }
    for (int i = 0; i < 9; ++i) finite = finite && isfinite(v[i]);
    for (int i = 0; i < 9; ++i) f[i] = finite ? v[i] : v0[i];
}

// The four candidates X1, X1(-t), X2, X2(-t) of the null vector f (module
// docstring step 4), on one thread: cand[c] holds R row-major, then t.
__device__ void candidates(const double* f, const float* kmat, const double* inv,
                           double cand[4][12]) {
    // Rank 2: drop the smallest column of f V.
    double col[3][3], vcol[3][3];
    svd3_columns(f, col, vcol);
    int c0, c1, c2;
    order3(col, &c0, &c1, &c2);
    for (int r = 0; r < 3; ++r) col[c2][r] = 0.0;
    double f2[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            f2[3 * i + j] =
                (col[0][i] * vcol[0][j] + col[1][i] * vcol[1][j]) + col[2][i] * vcol[2][j];
    const double t1[9] = {inv[0], 0.0, -1.0, 0.0, inv[1], -1.0, 0.0, 0.0, 1.0};
    const double t2[9] = {inv[2], 0.0, -1.0, 0.0, inv[3], -1.0, 0.0, 0.0, 1.0};
    double k[9], kt[9], t1t[9], tmp[9], fm[9], e[9];
    for (int i = 0; i < 9; ++i) k[i] = kmat[i];
    transpose3(k, kt);
    transpose3(t1, t1t);
    mul3(t1t, f2, tmp);
    mul3(tmp, t2, fm);
    mul3(kt, fm, tmp);
    mul3(tmp, k, e);

    // E = U S V^T; R1 = V W U^T, R2 = V W^T U^T, det-sign fixed.
    svd3_columns(e, col, vcol);
    order3(col, &c0, &c1, &c2);
    double sa = sqrt(dot3(col[c0], col[c0])), sb = sqrt(dot3(col[c1], col[c1]));
    sa = (sa == 0.0) ? 1.0 : sa;
    sb = (sb == 0.0) ? 1.0 : sb;
    double u[3][3];
    for (int r = 0; r < 3; ++r) {
        u[0][r] = col[c0][r] / sa;
        u[1][r] = col[c1][r] / sb;
    }
    u[2][0] = u[0][1] * u[1][2] - u[0][2] * u[1][1];
    u[2][1] = u[0][2] * u[1][0] - u[0][0] * u[1][2];
    u[2][2] = u[0][0] * u[1][1] - u[0][1] * u[1][0];
    const double* va = vcol[c0];
    const double* vb = vcol[c1];
    const double* vc = vcol[c2];
    double r1[9], r2[9];
    for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) {
            r1[3 * r + c] = (vb[r] * u[0][c] + (-va[r]) * u[1][c]) + vc[r] * u[2][c];
            r2[3 * r + c] = ((-vb[r]) * u[0][c] + va[r] * u[1][c]) + vc[r] * u[2][c];
        }
    const double det = (r1[0] * (r1[4] * r1[8] - r1[5] * r1[7]) -
                        r1[1] * (r1[3] * r1[8] - r1[5] * r1[6])) +
                       r1[2] * (r1[3] * r1[7] - r1[4] * r1[6]);
    const double sign = (det < 0.0) ? -1.0 : 1.0;
    for (int i = 0; i < 9; ++i) {
        r1[i] = sign * r1[i];
        r2[i] = sign * r2[i];
    }
    double m1m[9], m2m[9];
    mul3(r1, e, m1m);
    mul3(r2, e, m2m);
    const double ta[3] = {m1m[7], m1m[2], m1m[3]};
    const double tb[3] = {m2m[7], m2m[2], m2m[3]};
    for (int c = 0; c < 4; ++c) {
        const double* rr = (c < 2) ? r1 : r2;
        const double* tt = (c < 2) ? ta : tb;
        for (int i = 0; i < 9; ++i) cand[c][i] = rr[i];
        for (int i = 0; i < 3; ++i) cand[c][9 + i] = (c & 1) ? -tt[i] : tt[i];
    }
}

// Where the bootstrap instance writes (all (B, ...) row-major).
struct SeedOut {
    float* history;       // (B, 4, 4)
    float* tri_points;    // (B, S, 3)
    bool* tri_valid;      // (B, S)
    float* map_points;    // (B, C, 3)
    float* map_apps;      // (B, C, D)
    bool* map_valid;      // (B, C)
    int* map_count;       // (B,)
    int* lookup;          // (B, N)
};

template <bool SEED>
__global__ void __launch_bounds__(THREADS) eight_point_kernel(
    const float* __restrict__ kmat, const int* __restrict__ idx1, const int* __restrict__ idx2,
    const bool* __restrict__ valid, const float* __restrict__ p1, const float* __restrict__ p2,
    const bool* __restrict__ mask1, const bool* __restrict__ mask2,
    const float* __restrict__ apps2, PairStrides st, float* __restrict__ out, SeedOut seed,
    int S, int N, int capacity, int D, Mount mount) {
    __shared__ double A0[9][9], A[9][9], V[9][9];
    __shared__ double rows[THREADS][9];   // a chunk's design rows
    __shared__ bool live[THREADS];
    __shared__ double cand[4][12];        // R row-major, then t, of X1, X1(-t), X2, X2(-t)
    __shared__ double vote_m[4][12];      // per candidate: R^T K^-1 row-major, then -R^T t
    __shared__ double ik[9];
    __shared__ double part[WARPS][4];
    __shared__ int votes[4];
    __shared__ float pose[16];
    __shared__ float tri_m[21];           // K^-1, R^T K^-1 and -R^T t of the pose, float32
    __shared__ int scan[WARPS];
    extern __shared__ int first_slot[];   // SEED: (N,) smallest live slot a measurement
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long pair = blockIdx.x;
    const int* i1p = idx1 + pair * S;
    const int* i2p = idx2 + pair * S;
    const bool* vp = valid + pair * S;
    const float* q1 = p1 + pair * st.p1;
    const float* q2 = p2 + pair * st.p2;
    const bool* m1 = mask1 + pair * st.mask1;
    const bool* m2 = mask2 + pair * st.mask2;
    P1_STAMPS;

    // ---- 1. normalize_points: the masked max per axis of both frames ----
    double mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    for (int i = tid; i < N; i += THREADS) {
        const bool a = m1[i], b = m2[i];
        mx[0] = nan_max(mx[0], a ? static_cast<double>(q1[2 * i]) : 0.0);
        mx[1] = nan_max(mx[1], a ? static_cast<double>(q1[2 * i + 1]) : 0.0);
        mx[2] = nan_max(mx[2], b ? static_cast<double>(q2[2 * i]) : 0.0);
        mx[3] = nan_max(mx[3], b ? static_cast<double>(q2[2 * i + 1]) : 0.0);
    }
    for (int o = 16; o > 0; o >>= 1)
        for (int k = 0; k < 4; ++k) mx[k] = nan_max(mx[k], __shfl_xor_sync(FULL, mx[k], o));
    if (lane == 0)
        for (int k = 0; k < 4; ++k) part[warp][k] = mx[k];
    if (tid < 4) votes[tid] = 0;
    if (tid == 0) inv3(kmat, ik);
    if (SEED)
        for (int i = tid; i < N; i += THREADS) first_slot[i] = NO_SLOT;
    __syncthreads();
    double safe[4], inv[4];
    for (int k = 0; k < 4; ++k) {
        double m = part[0][k];
        for (int w = 1; w < WARPS; ++w) m = nan_max(m, part[w][k]);
        const double half = m * 0.5;
        safe[k] = (half == 0.0) ? 1.0 : half;
        inv[k] = 1.0 / safe[k];
    }
    P1_PHASE(0);

    // ---- 2. the normal matrix in float64, each entry in its fixed order ----
    double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};   // entries warp + 8 e
    for (int base = 0; base < S; base += THREADS) {
        const int s = min(base + tid, S - 1);
        // Every load issued at once; a dead row is zero: it changes no partial.
        const bool on = base + tid < S && vp[s];
        const int a = min(max(i1p[s], 0), N - 1), b = min(max(i2p[s], 0), N - 1);
        const float x1 = q1[2 * a], y1 = q1[2 * a + 1], x2 = q2[2 * b], y2 = q2[2 * b + 1];
        live[tid] = on;
        if (on) {
            const double d1[3] = {static_cast<double>(x1) / safe[0] - 1.0,
                                  static_cast<double>(y1) / safe[1] - 1.0, 1.0};
            const double d2[3] = {static_cast<double>(x2) / safe[2] - 1.0,
                                  static_cast<double>(y2) / safe[3] - 1.0, 1.0};
#pragma unroll
            for (int i = 0; i < 3; ++i)
#pragma unroll
                for (int j = 0; j < 3; ++j) rows[tid][3 * i + j] = d1[i] * d2[j];
        }
        __syncthreads();
        for (int step = 0; step < THREADS / 32 && base + 32 * step < S; ++step) {
            const int r = 32 * step + lane;
            if (!live[r]) continue;
#pragma unroll
            for (int e = 0; e < 6; ++e) {
                const int k = warp + WARPS * e;
                if (k < 45) acc[e] = acc[e] + rows[r][PAIR_X[k]] * rows[r][PAIR_Y[k]];
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < 6; ++e)
        for (int o = 16; o > 0; o >>= 1) acc[e] = acc[e] + __shfl_down_sync(FULL, acc[e], o);
    if (lane == 0)
#pragma unroll
        for (int e = 0; e < 6; ++e) {
            const int k = warp + WARPS * e;
            if (k < 45) {
                const int x = PAIR_X[k], y = PAIR_Y[k];
                A0[x][y] = acc[e];
                A0[y][x] = acc[e];
            }
        }
    __syncthreads();
    P1_PHASE(1);

    // ---- 3a. cyclic Jacobi of the 9x9 on warp 0, in registers ----
    if (warp == 0) jacobi(A0, A, V, lane);
    __syncthreads();
    P1_PHASE(2);

    // ---- 3b-4 on thread 0: null vector, F, E, candidates ----
    if (tid == 0) {
        double f[9];
        null_vector(A0, A, V, f);
        P1_PHASE(3);
        candidates(f, kmat, inv, cand);
        P1_PHASE(4);
    }
    __syncthreads();
    if (tid < 4) {
        const double* R = cand[tid];
        const double* t = cand[tid] + 9;
        double rt[9], irk[9];
        transpose3(R, rt);
        mul3(rt, ik, irk);
        for (int i = 0; i < 9; ++i) vote_m[tid][i] = irk[i];
        for (int k = 0; k < 3; ++k)
            vote_m[tid][9 + k] = -((R[k] * t[0] + R[3 + k] * t[1]) + R[6 + k] * t[2]);
    }
    __syncthreads();

    // ---- 5. the cheirality votes: (candidate, correspondence) items on the CTA ----
    int count[4] = {0, 0, 0, 0};
    for (int w = tid; w < 4 * S; w += THREADS) {
        const int cc = w / S, s = w - cc * S;
        const double* irk = vote_m[cc];
        const double* ti = vote_m[cc] + 9;
        const int a = min(max(i1p[s], 0), N - 1), b = min(max(i2p[s], 0), N - 1);
        const double x1 = q1[2 * a], y1 = q1[2 * a + 1], x2 = q2[2 * b], y2 = q2[2 * b + 1];
        double d1[3], d2[3];
        for (int r = 0; r < 3; ++r) {
            d1[r] = (ik[3 * r] * x1 + ik[3 * r + 1] * y1) + ik[3 * r + 2];
            d2[r] = (irk[3 * r] * x2 + irk[3 * r + 1] * y2) + irk[3 * r + 2];
        }
        const double a00 = dot3(d1, d1), a01 = -dot3(d1, d2), a11 = dot3(d2, d2);
        const double b0 = dot3(d1, ti), b1 = -dot3(d2, ti);
        const double det = a00 * a11 - a01 * a01;
        const double sd = (fabs(det) < DET_EPS) ? 1.0 : det;
        const double s0 = (a11 * b0 - a01 * b1) / sd;
        const double s1 = (a00 * b1 - a01 * b0) / sd;
        bool ok = vp[s] && s0 >= 0.0 && s1 >= 0.0 && fabs(det) >= DET_EPS;
        for (int k = 0; k < 3; ++k) {
            const double pk = ((s0 * d1[k] + ti[k]) + s1 * d2[k]) * 0.5;
            ok = ok && fabs(pk) < 1e18;
        }
        const int one = ok ? 1 : 0;
        count[0] += (cc == 0) ? one : 0;
        count[1] += (cc == 1) ? one : 0;
        count[2] += (cc == 2) ? one : 0;
        count[3] += (cc == 3) ? one : 0;
    }
    for (int cc = 0; cc < 4; ++cc) {
        for (int o = 16; o > 0; o >>= 1) count[cc] += __shfl_xor_sync(FULL, count[cc], o);
        if (lane == 0 && count[cc] != 0) atomicAdd(&votes[cc], count[cc]);
    }
    __syncthreads();
    P1_PHASE(5);

    // The pose: the first candidate with the most votes, the identity when none has one.
    if (tid == 0) {
        int best = 0;
        for (int cc = 1; cc < 4; ++cc)
            if (votes[cc] > votes[best]) best = cc;
        const bool won = votes[best] > 0;
        float x[16];
        for (int r = 0; r < 3; ++r) {
            for (int c = 0; c < 3; ++c)
                x[4 * r + c] = won ? static_cast<float>(cand[best][3 * r + c])
                                   : (r == c ? 1.0f : 0.0f);
            x[4 * r + 3] = won ? static_cast<float>(cand[best][9 + r]) : 0.0f;
        }
        x[12] = 0.0f;
        x[13] = 0.0f;
        x[14] = 0.0f;
        x[15] = 1.0f;
        if (SEED && mount.planar) {
            // c^-1 project_se2(c x c^-1) c, every product in float32.
            float ci[16], u[16], w[16];
            inverse4f(mount.m, ci);
            mul4f(mount.m, x, u);
            mul4f(u, ci, w);
            project_se2f(w, u);
            mul4f(ci, u, w);
            mul4f(w, mount.m, x);
        }
        for (int i = 0; i < 16; ++i) pose[i] = x[i];
        if (SEED) {
            // The triangulation's matrices: K^-1 and R^T K^-1 formed in
            // float64 and rounded once, -R^T t likewise.
            double R[9], rt[9], irk[9];
            for (int r = 0; r < 3; ++r)
                for (int c = 0; c < 3; ++c) R[3 * r + c] = x[4 * r + c];
            const double t[3] = {x[3], x[7], x[11]};
            transpose3(R, rt);
            mul3(rt, ik, irk);
            for (int i = 0; i < 9; ++i) {
                tri_m[i] = static_cast<float>(ik[i]);
                tri_m[9 + i] = static_cast<float>(irk[i]);
            }
            for (int k = 0; k < 3; ++k)
                tri_m[18 + k] =
                    static_cast<float>(-((R[k] * t[0] + R[3 + k] * t[1]) + R[6 + k] * t[2]));
        }
    }
    __syncthreads();
    if (tid < 16) out[pair * 16 + tid] = pose[tid];
    P1_PHASE(7);
    if (SEED) {
        if (tid == 16) {
            float hist[16];
            inverse4f(pose, hist);
            for (int i = 0; i < 16; ++i) seed.history[pair * 16 + i] = hist[i];
        }

        // ---- 6. triangulation, the map's compaction and the lookup, slot order ----
        const float* a2 = apps2 + pair * st.apps2;
        float* tp = seed.tri_points + pair * S * 3;
        bool* tv = seed.tri_valid + pair * S;
        float* mp = seed.map_points + pair * capacity * 3;
        float* ma = seed.map_apps + pair * capacity * D;
        int kept = 0;   // live slots before the chunk
        for (int base = 0; base < S; base += THREADS) {
            const int s = base + tid;
            bool ok = false;
            float pt[3] = {0.0f, 0.0f, 0.0f};
            int b = 0;
            if (s < S) {
                const int a = min(max(i1p[s], 0), N - 1);
                b = min(max(i2p[s], 0), N - 1);
                const float x1 = q1[2 * a], y1 = q1[2 * a + 1];
                const float x2 = q2[2 * b], y2 = q2[2 * b + 1];
                double d1[3], d2[3], tt[3];
                for (int r = 0; r < 3; ++r) {
                    d1[r] = (tri_m[3 * r] * x1 + tri_m[3 * r + 1] * y1) + tri_m[3 * r + 2];
                    d2[r] = (tri_m[9 + 3 * r] * x2 + tri_m[9 + 3 * r + 1] * y2) +
                            tri_m[9 + 3 * r + 2];
                    tt[r] = tri_m[18 + r];
                }
                const double a00 = dot3(d1, d1), a01 = -dot3(d1, d2), a11 = dot3(d2, d2);
                const double b0 = dot3(d1, tt), b1 = -dot3(d2, tt);
                const double det = a00 * a11 - a01 * a01;
                const double sd = (fabs(det) < DET_EPS) ? 1.0 : det;
                const double s0 = (a11 * b0 - a01 * b1) / sd;
                const double s1 = (a00 * b1 - a01 * b0) / sd;
                ok = vp[s] && s0 >= 0.0 && s1 >= 0.0 && fabs(det) >= DET_EPS;
                for (int k = 0; k < 3; ++k) {
                    pt[k] = static_cast<float>(((s0 * d1[k] + tt[k]) + s1 * d2[k]) * 0.5);
                    ok = ok && fabsf(pt[k]) < 1e18f;
                }
                for (int k = 0; k < 3; ++k) {
                    pt[k] = ok ? pt[k] : 0.0f;
                    tp[3 * s + k] = pt[k];
                }
                tv[s] = ok;
            }
            const unsigned ballot = __ballot_sync(FULL, ok);
            if (lane == 0) scan[warp] = __popc(ballot);
            __syncthreads();
            int before = kept + __popc(ballot & ((1u << lane) - 1u)), total = 0;
            for (int w = 0; w < WARPS; ++w) {
                before += (w < warp) ? scan[w] : 0;
                total += scan[w];
            }
            if (ok) {
                atomicMin(&first_slot[b], s);
                if (before < capacity) {
                    for (int k = 0; k < 3; ++k) mp[3 * before + k] = pt[k];
                    for (int k = 0; k < D; ++k) ma[before * D + k] = a2[b * D + k];
                }
            }
            kept += total;
            __syncthreads();
        }
        const int count = min(kept, capacity);
        if (tid == 0) seed.map_count[pair] = count;
        for (int i = 3 * count + tid; i < 3 * capacity; i += THREADS) mp[i] = 0.0f;
        for (int i = D * count + tid; i < D * capacity; i += THREADS) ma[i] = INFINITY;
        for (int i = tid; i < capacity; i += THREADS) seed.map_valid[pair * capacity + i] = i < count;
        for (int i = tid; i < N; i += THREADS) {
            const int f = first_slot[i];
            seed.lookup[pair * N + i] = (f == NO_SLOT) ? -1 : f;
        }
        P1_PHASE(6);
    }
#ifdef VO_P1_PHASES
    if (threadIdx.x == 0) atomicAdd(&vo_p1_phase_cycles[15], 1ull);
#endif
}

}  // namespace

#ifdef VO_P1_PHASES
// The diagnostic build's phase counters: copied out, then zeroed.
VO_EXPORT int vo_p1_phases_take(unsigned long long* host16) {
    cudaError_t err =
        cudaMemcpyFromSymbol(host16, vo_p1_phase_cycles, 16 * sizeof(unsigned long long));
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned long long zero[16] = {};
    return static_cast<int>(cudaMemcpyToSymbol(vo_p1_phase_cycles, zero, sizeof(zero)));
}
#endif

// The pose alone: out (B, 4, 4).
VO_EXPORT int vo_eight_point(const void* kmat, const void* idx1, const void* idx2,
                             const void* valid, const void* p1, const void* p2, const void* mask1,
                             const void* mask2, void* out, int B, int S, int N,
                             cudaStream_t stream) {
    eight_point_kernel<false><<<B, THREADS, 0, stream>>>(
        static_cast<const float*>(kmat), static_cast<const int*>(idx1),
        static_cast<const int*>(idx2), static_cast<const bool*>(valid),
        static_cast<const float*>(p1), static_cast<const float*>(p2),
        static_cast<const bool*>(mask1), static_cast<const bool*>(mask2), nullptr,
        PairStrides{2ll * N, 2ll * N, N, N, 0}, static_cast<float*>(out), SeedOut{}, S, N, 0, 0,
        Mount{});
    return vo_launch_status();
}

// The whole bootstrap: x_init and history (B, 4, 4), tri_points (B, S, 3),
// tri_valid (B, S), the seeded map (B, C, 3), (B, C, D), (B, C), count (B,),
// lookup (B, N); apps2 (B, N, D) the second frame's appearances. The frame
// inputs' pairs lie the given strides apart (in elements).
VO_EXPORT int vo_eight_point_seed(const void* kmat, const void* idx1, const void* idx2,
                                  const void* valid, const void* p1, const void* p2,
                                  const void* mask1, const void* mask2, const void* apps2,
                                  void* x_init, void* history, void* tri_points, void* tri_valid,
                                  void* map_points, void* map_apps, void* map_valid,
                                  void* map_count, void* lookup, int B, int S, int N,
                                  int capacity, int D, long long p1_stride, long long p2_stride,
                                  long long mask1_stride, long long mask2_stride,
                                  long long apps2_stride, Mount mount, cudaStream_t stream) {
    const size_t table = static_cast<size_t>(N) * sizeof(int);
    if (table > 24 * 1024) {   // past the default 48 KB beside the ~22 KB static
        const cudaError_t err = cudaFuncSetAttribute(
            eight_point_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(table));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const SeedOut seed{static_cast<float*>(history), static_cast<float*>(tri_points),
                       static_cast<bool*>(tri_valid), static_cast<float*>(map_points),
                       static_cast<float*>(map_apps), static_cast<bool*>(map_valid),
                       static_cast<int*>(map_count), static_cast<int*>(lookup)};
    eight_point_kernel<true><<<B, THREADS, table, stream>>>(
        static_cast<const float*>(kmat), static_cast<const int*>(idx1),
        static_cast<const int*>(idx2), static_cast<const bool*>(valid),
        static_cast<const float*>(p1), static_cast<const float*>(p2),
        static_cast<const bool*>(mask1), static_cast<const bool*>(mask2),
        static_cast<const float*>(apps2),
        PairStrides{p1_stride, p2_stride, mask1_stride, mask2_stride, apps2_stride},
        static_cast<float*>(x_init), seed, S, N, capacity, D, mount);
    return vo_launch_status();
}
