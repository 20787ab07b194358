// Native (CPU, C++) receiver-function synthesizer — TRANSLITERATED
// GOLDEN, not an independent implementation.
//
// The coefficient routines (interface_coeffs, free_surface,
// displacement) deliberately mirror the reference's factoring
// (src/extensions/rfmini/greens.cpp: coeffm / coeffs / Mueller 1985
// eq. 89) statement-for-statement so that bit-level comparison tests
// isolate JAX-kernel bugs from formula differences, per SURVEY.md §7.
// A mirrored golden cannot catch a bug inherited from the reference;
// the independent anchors are (1) the committed reference-output
// fixtures (tests/fixtures/st3_*.dat) and (2) the energy-flux R/T
// property tests that do not share this factoring
// (tests/test_native_physics.py).  Pipeline around the coefficients
// (Gauss low-pass, spectral-division decon, inverse real FFT) follows
// bayhunter_jax/ops/rf.py.

#include <cmath>
#include <complex>
#include <cstring>
#include <vector>

namespace {

using cd = std::complex<double>;

constexpr double kEarthR = 6371.0;     // rfmini uses 6371, not 6370
constexpr double kDegPerKm = 0.00899;  // s/deg -> s/km

struct M2 {  // complex 2x2 matrix
  cd m[2][2];
};

M2 mul(const M2& A, const M2& B) {
  M2 r;
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      r.m[i][j] = A.m[i][0] * B.m[0][j] + A.m[i][1] * B.m[1][j];
  return r;
}

M2 inv(const M2& A) {
  cd det = A.m[0][0] * A.m[1][1] - A.m[0][1] * A.m[1][0];
  cd q = 1.0 / det;
  M2 r;
  r.m[0][0] = q * A.m[1][1];
  r.m[0][1] = -q * A.m[0][1];
  r.m[1][0] = -q * A.m[1][0];
  r.m[1][1] = q * A.m[0][0];
  return r;
}

cd csqrt_conj(double x) {  // conj(sqrt(complex(x)))
  return x >= 0.0 ? cd(std::sqrt(x), 0.0) : cd(0.0, -std::sqrt(-x));
}
cd csqrt_plain(double x) {  // sqrt(complex(x))
  return x >= 0.0 ? cd(std::sqrt(x), 0.0) : cd(0.0, std::sqrt(-x));
}

// welded-interface P-SV R/T coefficients (downgoing + upgoing tables)
void interface_coeffs(double u, double vp1, double vs1, double rho1,
                      double vp2, double vs2, double rho2,
                      M2* rd, M2* td, M2* ru, M2* tu) {
  double mue1 = rho1 * vs1 * vs1, mue2 = rho2 * vs2 * vs2;
  double c = 2.0 * (mue1 - mue2);
  double u2 = u * u, cu2 = c * u2;
  cd a1 = csqrt_conj(1.0 / (vp1 * vp1) - u2);
  cd a2 = csqrt_conj(1.0 / (vp2 * vp2) - u2);
  cd b1 = csqrt_conj(1.0 / (vs1 * vs1) - u2);
  cd b2 = csqrt_conj(1.0 / (vs2 * vs2) - u2);

  double t1 = cu2 - rho1 + rho2, t2 = cu2 - rho1, t3 = cu2 + rho2;
  cd t4 = t3 * a1 - t2 * a2;

  cd d1 = t1 * t1 * u2 + t2 * t2 * a2 * b2 + rho1 * rho2 * a2 * b1;
  cd d2 = c * c * u2 * a1 * a2 * b1 * b2 + t3 * t3 * a1 * b1
          + rho1 * rho2 * a1 * b2;
  cd t5 = 1.0 / (d1 + d2);
  cd t7 = 2.0 * rho1 * t5;
  rd->m[0][0] = (d2 - d1) * t5;
  rd->m[1][0] = -2.0 * u * a1 * t5 * (t1 * t3 + c * t2 * a2 * b2);
  td->m[0][0] = a1 * t7 * (t3 * b1 - t2 * b2);
  td->m[1][0] = -a1 * t7 * u * (t1 + c * a2 * b1);
  rd->m[1][1] = (d2 - d1 - 2.0 * rho1 * rho2 * (a1 * b2 - a2 * b1))
                * t5;
  rd->m[0][1] = 2.0 * u * b1 * t5 * (t1 * t3 + c * t2 * a2 * b2);
  td->m[1][1] = b1 * t7 * t4;
  td->m[0][1] = b1 * t7 * u * (t1 + c * a1 * b2);

  d1 = t1 * t1 * u2 + t3 * t3 * a1 * b1 + rho1 * rho2 * a1 * b2;
  d2 = c * c * u2 * a1 * a2 * b1 * b2 + t2 * t2 * a2 * b2
       + rho1 * rho2 * a2 * b1;
  t5 = 1.0 / (d1 + d2);
  t7 = 2.0 * rho2 * t5;
  ru->m[0][0] = (d2 - d1) * t5;
  ru->m[1][0] = 2.0 * u * a2 * t5 * (t1 * t2 + c * t3 * a1 * b1);
  tu->m[0][0] = a2 * t7 * (t3 * b1 - t2 * b2);
  tu->m[1][0] = -a2 * t7 * u * (t1 + c * a1 * b2);
  ru->m[1][1] = (d2 - d1 - 2.0 * rho1 * rho2 * (a2 * b1 - a1 * b2))
                * t5;
  ru->m[0][1] = -2.0 * u * b2 * t5 * (t1 * t2 + c * t3 * a1 * b1);
  tu->m[1][1] = b2 * t7 * t4;
  tu->m[0][1] = b2 * t7 * u * (t1 + c * a2 * b1);
}

// free-surface P-SV reflection for upgoing waves (PLAIN sqrt branch)
M2 free_surface(double u, double vp, double vs) {
  double u2 = u * u;
  cd a = csqrt_plain(1.0 / (vp * vp) - u2);
  cd b = csqrt_plain(1.0 / (vs * vs) - u2);
  double t1 = 2.0 * vs * vs;
  double t2 = t1 * u2 - 1.0;
  cd d1 = t2 * t2;
  cd d2 = t1 * t1 * u2 * a * b;
  cd d = d1 + d2;
  cd t3 = 2.0 * t1 * u * t2 / d;
  M2 r;
  r.m[0][0] = (d2 - d1) / d;
  r.m[0][1] = -b * t3;
  r.m[1][0] = a * t3;
  r.m[1][1] = r.m[0][0];
  return r;
}

// free-surface displacement matrix (Mueller eq. 89)
M2 displacement(double u, double vp, double vs) {
  double vp2 = vp * vp, vs2 = vs * vs, p2 = u * u;
  double x = 1.0 - 2.0 * vs2 * p2;
  cd a1 = csqrt_conj(1.0 / vp2 - p2);
  cd b1 = csqrt_conj(1.0 / vs2 - p2);
  cd q = 1.0 / (x * x + 4.0 * vs2 * vs2 * p2 * a1 * b1);
  M2 h;
  h.m[0][0] = q * a1 * b1 * 2.0 * vs2 * u;
  h.m[0][1] = q * b1 * x;
  h.m[1][0] = q * a1 * x;
  h.m[1][1] = -q * a1 * b1 * 2.0 * vs2 * u;
  return h;
}

// in-place radix-2 complex FFT, sign = +1 inverse (no normalization)
void fft(std::vector<cd>& x, int sign) {
  int n = static_cast<int>(x.size());
  for (int i = 1, j = 0; i < n; ++i) {
    int bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(x[i], x[j]);
  }
  for (int len = 2; len <= n; len <<= 1) {
    double ang = sign * 2.0 * M_PI / len;
    cd wl(std::cos(ang), std::sin(ang));
    for (int i = 0; i < n; i += len) {
      cd w(1.0, 0.0);
      for (int k = 0; k < len / 2; ++k) {
        cd u = x[i + k], v = x[i + k + len / 2] * w;
        x[i + k] = u + v;
        x[i + k + len / 2] = u - v;
        w *= wl;
      }
    }
  }
}

// inverse real FFT of a half spectrum (nfreq = n/2 + 1) -> n samples
void irfft(const std::vector<cd>& half, int n, double* out) {
  std::vector<cd> full(n);
  for (int k = 0; k <= n / 2; ++k) full[k] = half[k];
  for (int k = n / 2 + 1; k < n; ++k) full[k] = std::conj(half[n - k]);
  fft(full, +1);
  for (int i = 0; i < n; ++i) out[i] = full[i].real() / n;
}

}  // namespace

extern "C" {

// Synthetic receiver function + Z/R responses.  Mirrors the reference
// entry point (reference: src/extensions/rfmini/synrf.cpp:16-55,
// wrap.cpp:57-80):
//   h/vp/vs/rho/qp/qs[nlayer] (halfspace last, spherical/unflattened),
//   p_sdeg slowness in s/deg, gauss_a Gauss width, nsamp power-of-2
//   FFT length, fsamp sampling rate, tshift left shift, nsv + poisson
//   surface rotation parameters, wave_type 0 P / 1 SV, flattening 0/1.
// Outputs fz/fr/rf of length nsamp.  Returns 0.
int bh_synrf(const double* h, const double* vp, const double* vs,
             const double* rho, const double* qp, const double* qs,
             int nlayer, double p_sdeg, double gauss_a, int nsamp,
             double fsamp, double tshift, double nsv, double poisson,
             int wave_type, int flattening, double fref,
             double* fz, double* fr, double* rf) {
  int nl = nlayer;
  double p = p_sdeg * kDegPerKm;
  double p2 = p * p;
  double vp_top = nsv * std::sqrt((1.0 - poisson) / (0.5 - poisson));
  double vs_top = nsv;

  // earth flattening at layer TOPS (rfmini variant)
  std::vector<double> hf(h, h + nl), vpf(vp, vp + nl),
      vsf(vs, vs + nl), rhof(rho, rho + nl);
  if (flattening) {
    double z_top = 0.0;
    for (int i = 0; i < nl; ++i) {
      double z_bot = z_top + h[i];
      double q_top = kEarthR / (kEarthR - z_top);
      double zf_top = kEarthR * std::log(q_top);
      double zf_bot = kEarthR * std::log(kEarthR / (kEarthR - z_bot));
      hf[i] = zf_bot - zf_top;
      vpf[i] = vp[i] * q_top;
      vsf[i] = vs[i] * q_top;
      rhof[i] = rho[i] / q_top;
      z_top = z_bot;
    }
  }

  int nfreq = nsamp / 2 + 1;
  double dw = 2.0 * M_PI * fsamp / nsamp;
  double wref = 2.0 * M_PI * fref;

  // interface coefficients (real elastic velocities), slot i = top of
  // layer i; slot 0 = free surface
  std::vector<M2> rd(nl), td(nl), ru(nl), tu(nl);
  ru[0] = free_surface(p, vpf[0], vsf[0]);
  for (int i = 1; i < nl; ++i)
    interface_coeffs(p, vpf[i - 1], vsf[i - 1], rhof[i - 1], vpf[i],
                     vsf[i], rhof[i], &rd[i], &td[i], &ru[i], &tu[i]);
  M2 hmat = displacement(p, vpf[0], vsf[0]);

  // direct-wave alignment time (halfspace uses the h=-1 sentinel)
  double t0 = 0.0;
  for (int i = 0; i < nl; ++i) {
    double v = (wave_type == 0) ? vpf[i] : vsf[i];
    double qv = std::sqrt(std::max(1.0 / (v * v) - p2, 0.0));
    t0 += (i == nl - 1 ? -1.0 : hf[i]) * qv;
  }

  std::vector<cd> cz(nfreq), cr(nfreq);
  for (int j = 0; j < nfreq; ++j) {
    double w = dw * j;
    double lgw = (j > 0) ? std::log(std::max(w, 1e-30) / wref) : 0.0;

    // per-layer diagonal phase matrices with anelastic velocities
    M2 nb, q, g;  // carried through the top-down recursion
    bool first = true;
    for (int i = 0; i < nl - 1; ++i) {
      cd vpc = vpf[i] * (1.0 + lgw / (M_PI * qp[i]) + cd(0, 0.5) / qp[i]);
      cd vsc = vsf[i] * (1.0 + lgw / (M_PI * qs[i]) + cd(0, 0.5) / qs[i]);
      cd plc = std::sqrt(1.0 / (vpc * vpc) - p2);
      cd slc = std::sqrt(1.0 / (vsc * vsc) - p2);
      cd e1 = std::exp(cd(0, -1.0) * (w * hf[i]) * plc);
      cd e2 = std::exp(cd(0, -1.0) * (w * hf[i]) * slc);

      M2 nt;
      if (first) {
        nt = ru[i];
      } else {
        M2 t = mul(mul(td[i], nb), q);
        nt = ru[i];
        for (int r = 0; r < 2; ++r)
          for (int s = 0; s < 2; ++s) nt.m[r][s] += t.m[r][s];
      }
      // nb = e nt e (diagonal sandwich)
      nb.m[0][0] = nt.m[0][0] * e1 * e1;
      nb.m[0][1] = nt.m[0][1] * e1 * e2;
      nb.m[1][0] = nt.m[1][0] * e1 * e2;
      nb.m[1][1] = nt.m[1][1] * e2 * e2;
      // q = inv(I - rd_{i+1} nb) tu_{i+1}
      M2 k = mul(rd[i + 1], nb);
      M2 imk;
      imk.m[0][0] = 1.0 - k.m[0][0];
      imk.m[0][1] = -k.m[0][1];
      imk.m[1][0] = -k.m[1][0];
      imk.m[1][1] = 1.0 - k.m[1][1];
      M2 q_new = mul(inv(imk), tu[i + 1]);
      // g = g (e q)
      M2 eq;
      eq.m[0][0] = e1 * q_new.m[0][0];
      eq.m[0][1] = e1 * q_new.m[0][1];
      eq.m[1][0] = e2 * q_new.m[1][0];
      eq.m[1][1] = e2 * q_new.m[1][1];
      g = first ? eq : mul(g, eq);
      q = q_new;
      first = false;
    }

    M2 t_resp = mul(hmat, g);
    for (int r = 0; r < 2; ++r)
      for (int s = 0; s < 2; ++s) t_resp.m[r][s] *= 2.0;
    cd czj = (wave_type == 0) ? t_resp.m[1][0] : t_resp.m[1][1];
    cd crj = (wave_type == 0) ? t_resp.m[0][0] : t_resp.m[0][1];
    cd qq = std::exp(cd(0, 1.0) * (w * t0));
    cz[j] = czj * qq;
    cr[j] = crj * qq;
  }

  // Z/R -> P/SV decomposition (surface rotation)
  if (vs_top > 0.01 && std::fabs(p) > 0.0001) {
    double a = std::sqrt(std::max(1.0 / (vp_top * vp_top) - p2, 1e-30));
    double b = std::sqrt(std::max(1.0 / (vs_top * vs_top) - p2, 1e-30));
    double m11 = -(2.0 * vs_top * vs_top * p2 - 1.0) / (vp_top * a);
    double m12 = 2.0 * p * vs_top * vs_top / vp_top;
    double m21 = -2.0 * p * vs_top;
    double m22 = (1.0 - 2.0 * vs_top * vs_top * p2) / (vs_top * b);
    for (int j = 0; j < nfreq; ++j) {
      cd z = cz[j], r = cr[j];
      cz[j] = z * m11 + r * m12;
      cr[j] = z * m21 + r * m22;
    }
  }

  if (wave_type == 1) std::swap(cz, cr);  // SV: deconvolve P with SV

  double qfac = std::sqrt(M_PI) * fsamp / gauss_a;
  std::vector<cd> crf(nfreq), crq(nfreq), czq(nfreq);
  for (int j = 0; j < nfreq; ++j) {
    double w = dw * j;
    double denom = std::norm(cz[j]);
    cd rfj = cr[j] * std::conj(cz[j]) / denom;
    double wa = std::min(w / gauss_a, 50.0);
    cd cq = qfac * std::exp(cd(-0.25 * wa * wa, 0.0)
                            - cd(0, 1.0) * (w * tshift));
    crf[j] = rfj * cq;
    crq[j] = cr[j] * cq;
    czq[j] = cz[j] * cq;
  }

  irfft(crf, nsamp, rf);
  irfft(crq, nsamp, fr);
  irfft(czq, nsamp, fz);
  return 0;
}

}  // extern "C"
