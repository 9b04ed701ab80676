// P1: the eight-point two-view pose of B frame pairs in one launch
// (ops/kernels/epipolar_kernel.py, whose module docstring gives the steps;
// its plain version, estimate_transform_batched_plain, repeats this
// arithmetic op for op and in the same order).
//
// Replaces no TPU kernel: the JAX package computes this step with XLA
// (visual_odometry_tpu/ops/epipolar.py:estimate_transform, vmapped by its
// batched programs). It exists so that a pair's pose has the same bits alone
// and in any batch: the card's batched library solvers pick their algorithm
// by the batch's size.
//
// Design: one CTA of one warp a pair, all arithmetic in float64 from the
// float32 inputs, the pose rounded to float32 once at the end. Lanes stride
// over the correspondences for the masked maxima, the 45 normal-matrix sums
// (serial lane partials, then a shuffle-down tree) and the cheirality votes.
// The cyclic Jacobi of the 9x9 runs on the warp in shared memory (every lane
// computes the rotation, lane j updates row j of A and lane 16 + j row j of
// V); the LU, the inverse iterations and the two 3x3 SVDs run on lane 0.
// Bound: at the pipeline's shapes (64 pairs x 128 correspondences, or one
// pair x 1,024) the work is a few hundred thousand operations and a few
// hundred KB, far below one launch; the kernel's time is its serial chain
// (Jacobi rotations, float64 divides and square roots), which it keeps on
// one warp a pair so that B pairs run side by side on the SMs.
#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int JACOBI_SWEEPS = 50;
constexpr int JACOBI_ZERO_FROM = 4;
constexpr int SVD3_SWEEPS = 16;
constexpr double SVD3_TOL = 0x1p-50;
constexpr int INVERSE_ITERATIONS = 3;

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

__global__ void __launch_bounds__(32) eight_point_kernel(
    const float* __restrict__ kmat, const int* __restrict__ idx1, const int* __restrict__ idx2,
    const bool* __restrict__ valid, const float* __restrict__ p1, const float* __restrict__ p2,
    const bool* __restrict__ mask1, const bool* __restrict__ mask2, float* __restrict__ out,
    int S, int N) {
    __shared__ double A0[9][9], A[9][9], V[9][9];
    __shared__ double cand[4][12];   // R row-major, then t, of X1, X1(-t), X2, X2(-t)
    const int lane = threadIdx.x;
    const long long pair = blockIdx.x;
    const int* i1p = idx1 + pair * S;
    const int* i2p = idx2 + pair * S;
    const bool* vp = valid + pair * S;
    const float* q1 = p1 + pair * N * 2;
    const float* q2 = p2 + pair * N * 2;
    const bool* m1 = mask1 + pair * N;
    const bool* m2 = mask2 + pair * N;

    // ---- 1. normalize_points: the masked max per axis of both frames ----
    double mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    for (int i = lane; i < N; i += 32) {
        const bool a = m1[i], b = m2[i];
        mx[0] = nan_max(mx[0], a ? static_cast<double>(q1[2 * i]) : 0.0);
        mx[1] = nan_max(mx[1], a ? static_cast<double>(q1[2 * i + 1]) : 0.0);
        mx[2] = nan_max(mx[2], b ? static_cast<double>(q2[2 * i]) : 0.0);
        mx[3] = nan_max(mx[3], b ? static_cast<double>(q2[2 * i + 1]) : 0.0);
    }
    for (int o = 16; o > 0; o >>= 1)
        for (int k = 0; k < 4; ++k) mx[k] = nan_max(mx[k], __shfl_xor_sync(FULL, mx[k], o));
    double safe[4], inv[4];
    for (int k = 0; k < 4; ++k) {
        const double half = mx[k] * 0.5;
        safe[k] = (half == 0.0) ? 1.0 : half;
        inv[k] = 1.0 / safe[k];
    }

    // ---- 2. the normal matrix in float64, in the lanes' fixed order ----
    double acc[45];
#pragma unroll
    for (int k = 0; k < 45; ++k) acc[k] = 0.0;
    for (int s = lane; s < S; s += 32) {
        if (!vp[s]) continue;   // its design row is zero: it changes no partial
        const int a = min(max(i1p[s], 0), N - 1), b = min(max(i2p[s], 0), N - 1);
        const double d1[3] = {static_cast<double>(q1[2 * a]) / safe[0] - 1.0,
                              static_cast<double>(q1[2 * a + 1]) / safe[1] - 1.0, 1.0};
        const double d2[3] = {static_cast<double>(q2[2 * b]) / safe[2] - 1.0,
                              static_cast<double>(q2[2 * b + 1]) / safe[3] - 1.0, 1.0};
        double r[9];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) r[3 * i + j] = d1[i] * d2[j];
        int k = 0;
#pragma unroll
        for (int x = 0; x < 9; ++x)
#pragma unroll
            for (int y = x; y < 9; ++y) {
                acc[k] = acc[k] + r[x] * r[y];
                ++k;
            }
    }
#pragma unroll
    for (int k = 0; k < 45; ++k)
        for (int o = 16; o > 0; o >>= 1) acc[k] = acc[k] + __shfl_down_sync(FULL, acc[k], o);
    if (lane == 0) {
        int k = 0;
#pragma unroll
        for (int x = 0; x < 9; ++x)
#pragma unroll
            for (int y = x; y < 9; ++y) {
                A0[x][y] = A[x][y] = acc[k];
                A0[y][x] = A[y][x] = acc[k];
                ++k;
            }
    }
    if (lane < 9)
        for (int j = 0; j < 9; ++j) V[lane][j] = (j == lane) ? 1.0 : 0.0;
    __syncwarp();

    // ---- 3a. cyclic Jacobi of the 9x9, on the warp ----
    for (int sweep = 0; sweep < JACOBI_SWEEPS; ++sweep) {
        bool nz = false;
        if (lane < 9)
            for (int j = 0; j < 9; ++j) nz = nz || (j != lane && A[lane][j] != 0.0);
        if (!__any_sync(FULL, nz)) break;
        for (int p = 0; p < 8; ++p)
            for (int q = p + 1; q < 9; ++q) {
                const double apq = A[p][q], app = A[p][p], aqq = A[q][q];
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
                    if (lane < 9 && lane != p && lane != q) {
                        const double gp = A[lane][p], hq = A[lane][q];
                        const double np = gp - s * (hq + gp * tau);
                        const double nq = hq + s * (gp - hq * tau);
                        A[lane][p] = np;
                        A[p][lane] = np;
                        A[lane][q] = nq;
                        A[q][lane] = nq;
                    } else if (lane >= 16 && lane < 25) {
                        const int j = lane - 16;
                        const double gp = V[j][p], hq = V[j][q];
                        V[j][p] = gp - s * (hq + gp * tau);
                        V[j][q] = hq + s * (gp - hq * tau);
                    }
                    if (lane == 0) {
                        A[p][p] = app - hh;
                        A[q][q] = aqq + hh;
                        A[p][q] = 0.0;
                        A[q][p] = 0.0;
                    }
                }
                __syncwarp();
            }
    }

    // ---- 3b-5 on lane 0: null vector, F, E, candidates ----
    if (lane == 0) {
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
        double f[9];
        for (int i = 0; i < 9; ++i) f[i] = finite ? v[i] : v0[i];

        // Rank 2: drop the smallest column of f V.
        double col[3][3], vcol[3][3];
        svd3_columns(f, col, vcol);
        int c0, c1, c2;
        order3(col, &c0, &c1, &c2);
        for (int r = 0; r < 3; ++r) col[c2][r] = 0.0;
        double f2[9];
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j)
                f2[3 * i + j] = (col[0][i] * vcol[0][j] + col[1][i] * vcol[1][j]) +
                                col[2][i] * vcol[2][j];
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
    __syncwarp();

    // ---- 5. the cheirality votes over the correspondences ----
    double m[9];
    for (int i = 0; i < 9; ++i) m[i] = kmat[i];
    double c[3][3] = {
        {m[4] * m[8] - m[5] * m[7], m[5] * m[6] - m[3] * m[8], m[3] * m[7] - m[4] * m[6]},
        {m[2] * m[7] - m[1] * m[8], m[0] * m[8] - m[2] * m[6], m[1] * m[6] - m[0] * m[7]},
        {m[1] * m[5] - m[2] * m[4], m[2] * m[3] - m[0] * m[5], m[0] * m[4] - m[1] * m[3]}};
    const double kdet = (m[0] * c[0][0] + m[1] * c[0][1]) + m[2] * c[0][2];
    double ik[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) ik[3 * i + j] = c[j][i] / kdet;
    int votes[4];
    for (int cc = 0; cc < 4; ++cc) {
        const double* R = cand[cc];
        const double* t = cand[cc] + 9;
        double rt[9], irk[9], ti[3];
        transpose3(R, rt);
        mul3(rt, ik, irk);
        for (int k = 0; k < 3; ++k) ti[k] = -((R[k] * t[0] + R[3 + k] * t[1]) + R[6 + k] * t[2]);
        int count = 0;
        for (int s = lane; s < S; s += 32) {
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
            const double sd = (fabs(det) < 1e-12) ? 1.0 : det;
            const double s0 = (a11 * b0 - a01 * b1) / sd;
            const double s1 = (a00 * b1 - a01 * b0) / sd;
            bool ok = vp[s] && s0 >= 0.0 && s1 >= 0.0 && fabs(det) >= 1e-12;
            for (int k = 0; k < 3; ++k) {
                const double pk = ((s0 * d1[k] + ti[k]) + s1 * d2[k]) * 0.5;
                ok = ok && fabs(pk) < 1e18;
            }
            count += ok ? 1 : 0;
        }
        for (int o = 16; o > 0; o >>= 1) count += __shfl_xor_sync(FULL, count, o);
        votes[cc] = count;
    }
    if (lane == 0) {
        int best = 0;
        for (int cc = 1; cc < 4; ++cc)
            if (votes[cc] > votes[best]) best = cc;
        float* o = out + pair * 16;
        const bool won = votes[best] > 0;
        for (int r = 0; r < 3; ++r) {
            for (int cidx = 0; cidx < 3; ++cidx)
                o[4 * r + cidx] = won ? static_cast<float>(cand[best][3 * r + cidx])
                                      : (r == cidx ? 1.0f : 0.0f);
            o[4 * r + 3] = won ? static_cast<float>(cand[best][9 + r]) : 0.0f;
        }
        o[12] = 0.0f;
        o[13] = 0.0f;
        o[14] = 0.0f;
        o[15] = 1.0f;
    }
}

}  // namespace

VO_EXPORT int vo_eight_point(const void* kmat, const void* idx1, const void* idx2,
                             const void* valid, const void* p1, const void* p2, const void* mask1,
                             const void* mask2, void* out, int B, int S, int N,
                             cudaStream_t stream) {
    eight_point_kernel<<<B, 32, 0, stream>>>(
        static_cast<const float*>(kmat), static_cast<const int*>(idx1),
        static_cast<const int*>(idx2), static_cast<const bool*>(valid),
        static_cast<const float*>(p1), static_cast<const float*>(p2),
        static_cast<const bool*>(mask1), static_cast<const bool*>(mask2),
        static_cast<float*>(out), S, N);
    return vo_launch_status();
}
