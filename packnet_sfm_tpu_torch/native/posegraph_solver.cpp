// Native pose-graph Gauss-Newton solver (host-side runtime component).
//
// The port's copy of native/posegraph_solver.cpp. Same math as
// packnet_sfm_tpu_torch/egomotion/posegraph.py (SE(3) edges, per-keyframe
// log-scale variables eliminated by Schur complement, gauge priors) in
// dependency-free C++, in float64, with central-difference Jacobians: the
// low-latency host path for long-sequence odometry post-processing. Built
// on its own (no image libraries) by packnet_sfm_tpu_torch/native/__init__.py;
// held to both pose graphs in tests/test_torch_native.py.
//
// C ABI:
//   pn_solve_pose_graph(n, poses_io[16n], e, ei[e], ej[e], Z[16e], w[e],
//                       iters, rot_weight, optimize_scales, pose_prior,
//                       scale_prior, damping, scales_out[n])
//   returns final cost (<0 on error).

#include <cmath>
#include <cstring>
#include <vector>

namespace {

struct Mat4 { double v[16]; };

// ------------------------------------------------------------ small linalg

void mat4_mul(const double* a, const double* b, double* out) {
  double tmp[16];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      double s = 0;
      for (int k = 0; k < 4; ++k) s += a[i * 4 + k] * b[k * 4 + j];
      tmp[i * 4 + j] = s;
    }
  std::memcpy(out, tmp, sizeof(tmp));
}

void mat4_inv_se3(const double* T, double* out) {
  // [R t; 0 1]^-1 = [R^T -R^T t; 0 1]
  double R[9] = {T[0], T[1], T[2], T[4], T[5], T[6], T[8], T[9], T[10]};
  double t[3] = {T[3], T[7], T[11]};
  double o[16] = {R[0], R[3], R[6], 0, R[1], R[4], R[7], 0,
                  R[2], R[5], R[8], 0, 0,    0,    0,    1};
  o[3] = -(o[0] * t[0] + o[1] * t[1] + o[2] * t[2]);
  o[7] = -(o[4] * t[0] + o[5] * t[1] + o[6] * t[2]);
  o[11] = -(o[8] * t[0] + o[9] * t[1] + o[10] * t[2]);
  std::memcpy(out, o, sizeof(o));
}

void se3_exp(const double* xi, double* T) {
  const double *v = xi, *w = xi + 3;
  double th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  double th = std::sqrt(th2);
  double A, B, C;
  if (th < 1e-6) {
    A = 1 - th2 / 6;
    B = 0.5 - th2 / 24;
    C = 1.0 / 6 - th2 / 120;
  } else {
    A = std::sin(th) / th;
    B = (1 - std::cos(th)) / th2;
    C = (th - std::sin(th)) / (th2 * th);
  }
  double W[9] = {0, -w[2], w[1], w[2], 0, -w[0], -w[1], w[0], 0};
  double W2[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += W[i * 3 + k] * W[k * 3 + j];
      W2[i * 3 + j] = s;
    }
  double R[9], V[9];
  for (int i = 0; i < 9; ++i) {
    double eye = (i % 4 == 0) ? 1.0 : 0.0;
    R[i] = eye + A * W[i] + B * W2[i];
    V[i] = eye + B * W[i] + C * W2[i];
  }
  double t[3];
  for (int i = 0; i < 3; ++i)
    t[i] = V[i * 3] * v[0] + V[i * 3 + 1] * v[1] + V[i * 3 + 2] * v[2];
  double out[16] = {R[0], R[1], R[2], t[0], R[3], R[4], R[5], t[1],
                    R[6], R[7], R[8], t[2], 0,    0,    0,    1};
  std::memcpy(T, out, sizeof(out));
}

void se3_log(const double* T, double* xi) {
  double R[9] = {T[0], T[1], T[2], T[4], T[5], T[6], T[8], T[9], T[10]};
  double t[3] = {T[3], T[7], T[11]};
  double tr = R[0] + R[4] + R[8];
  double c = std::fmin(std::fmax((tr - 1) / 2, -1 + 1e-9), 1 - 1e-9);
  double th = std::acos(c);
  double w[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};
  double scale = (th < 1e-6) ? 0.5 + th * th / 12
                             : th / (2 * std::sin(th));
  for (int i = 0; i < 3; ++i) w[i] *= scale;
  double th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  th = std::sqrt(th2);
  double W[9] = {0, -w[2], w[1], w[2], 0, -w[0], -w[1], w[0], 0};
  double W2[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += W[i * 3 + k] * W[k * 3 + j];
      W2[i * 3 + j] = s;
    }
  double coef = (th < 1e-6)
                    ? 1.0 / 12 + th2 / 720
                    : (1.0 / th2) -
                          (1 + std::cos(th)) / (2 * th * std::sin(th));
  double Vinv[9];
  for (int i = 0; i < 9; ++i) {
    double eye = (i % 4 == 0) ? 1.0 : 0.0;
    Vinv[i] = eye - 0.5 * W[i] + coef * W2[i];
  }
  for (int i = 0; i < 3; ++i)
    xi[i] = Vinv[i * 3] * t[0] + Vinv[i * 3 + 1] * t[1] + Vinv[i * 3 + 2] * t[2];
  for (int i = 0; i < 3; ++i) xi[3 + i] = w[i];
}

// Cholesky solve (in-place, SPD): A x = b, dim d.
bool chol_solve(std::vector<double>& A, std::vector<double>& b, int d) {
  for (int i = 0; i < d; ++i) {
    for (int j = 0; j <= i; ++j) {
      double s = A[i * d + j];
      for (int k = 0; k < j; ++k) s -= A[i * d + k] * A[j * d + k];
      if (i == j) {
        if (s <= 0) return false;
        A[i * d + i] = std::sqrt(s);
      } else {
        A[i * d + j] = s / A[j * d + j];
      }
    }
  }
  for (int i = 0; i < d; ++i) {
    double s = b[i];
    for (int k = 0; k < i; ++k) s -= A[i * d + k] * b[k];
    b[i] = s / A[i * d + i];
  }
  for (int i = d - 1; i >= 0; --i) {
    double s = b[i];
    for (int k = i + 1; k < d; ++k) s -= A[k * d + i] * b[k];
    b[i] = s / A[i * d + i];
  }
  return true;
}

struct Edge {
  int i, j;
  Mat4 Z;
  double w;
};

void edge_residual(const std::vector<Mat4>& T, const std::vector<double>& s,
                   const Edge& e, double rot_weight, double* r) {
  Mat4 Zs;
  std::memcpy(Zs.v, e.Z.v, sizeof(Mat4));
  double sc = std::exp(s[e.i]);
  Zs.v[3] *= sc;
  Zs.v[7] *= sc;
  Zs.v[11] *= sc;
  Mat4 Zinv, Tiinv, rel, tmp;
  mat4_inv_se3(Zs.v, Zinv.v);
  mat4_inv_se3(T[e.i].v, Tiinv.v);
  mat4_mul(Tiinv.v, T[e.j].v, tmp.v);
  mat4_mul(Zinv.v, tmp.v, rel.v);
  se3_log(rel.v, r);
  for (int k = 3; k < 6; ++k) r[k] *= rot_weight;
  for (int k = 0; k < 6; ++k) r[k] *= e.w;
}

}  // namespace

extern "C" {

// poses_io: row-major [n,4,4] doubles, updated in place.
double pn_solve_pose_graph(int n, double* poses_io, int e, const int* ei,
                           const int* ej, const double* Z, const double* w,
                           int iters, double rot_weight, int optimize_scales,
                           double pose_prior, double scale_prior,
                           double damping, double* scales_out) {
  std::vector<Mat4> T(n);
  for (int i = 0; i < n; ++i) std::memcpy(T[i].v, poses_io + 16 * i, sizeof(Mat4));
  std::vector<Edge> edges(e);
  for (int k = 0; k < e; ++k) {
    edges[k].i = ei[k];
    edges[k].j = ej[k];
    std::memcpy(edges[k].Z.v, Z + 16 * k, sizeof(Mat4));
    edges[k].w = w[k];
  }
  std::vector<double> scales(n, 0.0);

  const int dp = 6 * n;
  const int dim = optimize_scales ? dp + n : dp;
  const double h = 1e-6;  // central differences on the local twist/scale

  for (int it = 0; it < iters; ++it) {
    std::vector<double> H(size_t(dim) * dim, 0.0), b(dim, 0.0);
    for (const Edge& ed : edges) {
      double r0[6];
      edge_residual(T, scales, ed, rot_weight, r0);
      // Jacobian columns: perturb pose i, pose j (left-multiplied twists)
      // and scale s_i with central differences.
      int cols_idx[13];
      double J[6 * 13];
      int nc = 0;
      auto add_pose_cols = [&](int pidx) {
        for (int d = 0; d < 6; ++d) {
          double xi[6] = {0, 0, 0, 0, 0, 0};
          Mat4 Tp, Tm, dT;
          xi[d] = h;
          se3_exp(xi, dT.v);
          std::vector<Mat4> Tmod(T);
          mat4_mul(dT.v, T[pidx].v, Tp.v);
          std::memcpy(Tmod[pidx].v, Tp.v, sizeof(Mat4));
          double rp[6];
          edge_residual(Tmod, scales, ed, rot_weight, rp);
          xi[d] = -h;
          se3_exp(xi, dT.v);
          mat4_mul(dT.v, T[pidx].v, Tm.v);
          std::memcpy(Tmod[pidx].v, Tm.v, sizeof(Mat4));
          double rm[6];
          edge_residual(Tmod, scales, ed, rot_weight, rm);
          for (int q = 0; q < 6; ++q) J[q * 13 + nc] = (rp[q] - rm[q]) / (2 * h);
          cols_idx[nc++] = pidx * 6 + d;
        }
      };
      add_pose_cols(ed.i);
      add_pose_cols(ed.j);
      if (optimize_scales) {
        std::vector<double> sp(scales), sm(scales);
        sp[ed.i] += h;
        sm[ed.i] -= h;
        double rp[6], rm[6];
        edge_residual(T, sp, ed, rot_weight, rp);
        edge_residual(T, sm, ed, rot_weight, rm);
        for (int q = 0; q < 6; ++q) J[q * 13 + nc] = (rp[q] - rm[q]) / (2 * h);
        cols_idx[nc++] = dp + ed.i;
      }
      for (int a = 0; a < nc; ++a) {
        double ba = 0;
        for (int q = 0; q < 6; ++q) ba += J[q * 13 + a] * r0[q];
        b[cols_idx[a]] += ba;
        for (int c2 = 0; c2 < nc; ++c2) {
          double s = 0;
          for (int q = 0; q < 6; ++q) s += J[q * 13 + a] * J[q * 13 + c2];
          H[size_t(cols_idx[a]) * dim + cols_idx[c2]] += s;
        }
      }
    }
    // gauge priors + damping
    for (int d = 0; d < 6; ++d) H[size_t(d) * dim + d] += pose_prior;
    if (optimize_scales) H[size_t(dp) * dim + dp] += scale_prior;
    for (int d = 0; d < dim; ++d) H[size_t(d) * dim + d] += damping;
    // Schur elimination of the (diagonal) scale block.
    std::vector<double> Hpp(size_t(dp) * dp), bp(dp);
    for (int a = 0; a < dp; ++a) {
      bp[a] = b[a];
      for (int c2 = 0; c2 < dp; ++c2) Hpp[size_t(a) * dp + c2] = H[size_t(a) * dim + c2];
    }
    std::vector<double> ds(n, 0.0);
    if (optimize_scales) {
      for (int si = 0; si < n; ++si) {
        double hss = H[size_t(dp + si) * dim + dp + si];
        if (hss <= 0) continue;
        for (int a = 0; a < dp; ++a) {
          double hps_a = H[size_t(a) * dim + dp + si];
          bp[a] -= hps_a * b[dp + si] / hss;
          for (int c2 = 0; c2 < dp; ++c2)
            Hpp[size_t(a) * dp + c2] -=
                hps_a * H[size_t(dp + si) * dim + c2] / hss;
        }
      }
    }
    if (!chol_solve(Hpp, bp, dp)) return -1.0;
    for (int a = 0; a < dp; ++a) bp[a] = -bp[a];
    if (optimize_scales) {
      for (int si = 0; si < n; ++si) {
        double hss = H[size_t(dp + si) * dim + dp + si];
        if (hss <= 0) continue;
        double acc = b[dp + si];
        for (int a = 0; a < dp; ++a)
          acc += H[size_t(dp + si) * dim + a] * bp[a];
        ds[si] = -acc / hss;
      }
    }
    for (int i = 0; i < n; ++i) {
      Mat4 dT, Tn;
      se3_exp(&bp[6 * i], dT.v);
      mat4_mul(dT.v, T[i].v, Tn.v);
      std::memcpy(T[i].v, Tn.v, sizeof(Mat4));
      scales[i] += ds[i];
    }
  }

  double cost = 0;
  for (const Edge& ed : edges) {
    double r[6];
    edge_residual(T, scales, ed, rot_weight, r);
    for (int q = 0; q < 6; ++q) cost += r[q] * r[q];
  }
  for (int i = 0; i < n; ++i) std::memcpy(poses_io + 16 * i, T[i].v, sizeof(Mat4));
  if (scales_out)
    for (int i = 0; i < n; ++i) scales_out[i] = scales[i];
  return cost;
}

}  // extern "C"
