// McMurchie-Davidson one-electron integrals — native engine (a copy of
// x2gnn_tpu/data/integrals/csrc/integrals.cpp).
//
// Same math as ../md.py (the numpy engine it is checked against):
// Hermite expansion for overlap/kinetic, Hermite Coulomb + Boys function
// for nuclear attraction, real solid-harmonic cart->sph transform,
// OpenMP parallelism over shell pairs. The reference project outsources
// this to PySCF/libcint (scf.py:27-48); this engine has no dependency
// beyond libm/OpenMP.
//
// Built at first use by ../engine.py (g++ -O3 -march=native -shared -fPIC
// -fopenmp) into build/integrals/.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int LMAX = 3;

inline int ncart(int l) { return (l + 1) * (l + 2) / 2; }
inline int nsph(int l) { return 2 * l + 1; }

struct Mono { int x, y, z; };

// lexicographic cartesian monomials, matching md.py cart_monomials
static void monomials(int l, std::vector<Mono>& out) {
  out.clear();
  for (int i = l; i >= 0; --i)
    for (int j = l - i; j >= 0; --j)
      out.push_back({i, j, l - i - j});
}

// real solid-harmonic coefficients, rows m=-l..l over cart monomials;
// identical tables to md.py solid_harmonic_coeffs
static void sph_coeffs(int l, std::vector<double>& C) {
  std::vector<Mono> mons;
  monomials(l, mons);
  const int nc = (int)mons.size();
  C.assign((size_t)nsph(l) * nc, 0.0);
  auto put = [&](int row, int x, int y, int z, double v) {
    for (int i = 0; i < nc; ++i)
      if (mons[i].x == x && mons[i].y == y && mons[i].z == z) {
        C[(size_t)row * nc + i] = v;
        return;
      }
  };
  switch (l) {
    case 0: put(0, 0, 0, 0, 1.0); break;
    case 1:
      put(0, 0, 1, 0, 1.0);
      put(1, 0, 0, 1, 1.0);
      put(2, 1, 0, 0, 1.0);
      break;
    case 2:
      put(0, 1, 1, 0, 1.0);
      put(1, 0, 1, 1, 1.0);
      put(2, 2, 0, 0, -0.5);
      put(2, 0, 2, 0, -0.5);
      put(2, 0, 0, 2, 1.0);
      put(3, 1, 0, 1, 1.0);
      put(4, 2, 0, 0, 0.5);
      put(4, 0, 2, 0, -0.5);
      break;
    case 3:
      put(0, 2, 1, 0, 3.0);
      put(0, 0, 3, 0, -1.0);
      put(1, 1, 1, 1, 1.0);
      put(2, 2, 1, 0, -1.0);
      put(2, 0, 3, 0, -1.0);
      put(2, 0, 1, 2, 4.0);
      put(3, 2, 0, 1, -3.0);
      put(3, 0, 2, 1, -3.0);
      put(3, 0, 0, 3, 2.0);
      put(4, 2, 0, 1, 1.0);
      put(4, 0, 2, 1, -1.0);
      put(5, 3, 0, 0, -1.0);
      put(5, 1, 2, 0, -1.0);
      put(5, 1, 0, 2, 4.0);
      put(6, 3, 0, 0, 1.0);
      put(6, 1, 2, 0, -3.0);
      break;
  }
}

// 1D Hermite expansion E[t][i][j]; dims (tmax+1) x (imax+1) x (jmax+1)
struct Etab {
  int imax, jmax, tmax;
  std::vector<double> d;
  double at(int t, int i, int j) const {
    if (t < 0 || t > i + j) return 0.0;
    return d[((size_t)t * (imax + 1) + i) * (jmax + 1) + j];
  }
  double& ref(int t, int i, int j) {
    return d[((size_t)t * (imax + 1) + i) * (jmax + 1) + j];
  }
};

static void hermite_E(int imax, int jmax, double a, double b, double AB,
                      Etab& E) {
  const double p = a + b, q = a * b / p;
  const double XPA = -b * AB / p, XPB = a * AB / p;
  E.imax = imax;
  E.jmax = jmax;
  E.tmax = imax + jmax;
  E.d.assign((size_t)(E.tmax + 1) * (imax + 1) * (jmax + 1), 0.0);
  E.ref(0, 0, 0) = std::exp(-q * AB * AB);
  for (int i = 1; i <= imax; ++i)
    for (int t = 0; t <= i; ++t)
      E.ref(t, i, 0) = E.at(t - 1, i - 1, 0) / (2 * p) +
                       XPA * E.at(t, i - 1, 0) +
                       (t + 1) * E.at(t + 1, i - 1, 0);
  for (int j = 1; j <= jmax; ++j)
    for (int i = 0; i <= imax; ++i)
      for (int t = 0; t <= i + j; ++t)
        E.ref(t, i, j) = E.at(t - 1, i, j - 1) / (2 * p) +
                         XPB * E.at(t, i, j - 1) +
                         (t + 1) * E.at(t + 1, i, j - 1);
}

// Boys function F_m(T), m = 0..mmax
static void boys(int mmax, double T, double* F) {
  const double eT = std::exp(-T);
  if (T < 1e-12) {
    for (int m = 0; m <= mmax; ++m) F[m] = 1.0 / (2 * m + 1);
    return;
  }
  if (T < 35.0) {
    // series at m = mmax, then downward recurrence
    double denom = 2 * mmax + 1;
    double term = 1.0 / denom;
    double sum = term;
    for (int i = 1; i < 200; ++i) {
      denom += 2.0;
      term *= 2.0 * T / denom;
      sum += term;
      if (term < 1e-17 * sum) break;
    }
    F[mmax] = eT * sum;
    for (int m = mmax - 1; m >= 0; --m)
      F[m] = (2.0 * T * F[m + 1] + eT) / (2 * m + 1);
  } else {
    F[0] = 0.5 * std::sqrt(M_PI / T);
    for (int m = 0; m < mmax; ++m)
      F[m + 1] = ((2 * m + 1) * F[m] - eT) / (2.0 * T);
  }
}

// Hermite Coulomb R^0_{tuv}; R sized (tmax+1)^3, upper bound tmax = la+lb.
// `F` and `buf` are caller-provided scratch (this runs natoms * nprim^2
// times per shell pair — a heap allocation per call dominated the profile).
// Every (n,t,u,v) cell read below is written by an earlier recurrence step
// (the n-ranges shrink exactly with t+u+v), so the scratch needs no zeroing.
static void hermite_R(int tmax, double p, const double* PC, double* R,
                      std::vector<double>& F, std::vector<double>& buf) {
  const int n_max = 3 * tmax;
  const double T = p * (PC[0] * PC[0] + PC[1] * PC[1] + PC[2] * PC[2]);
  F.resize(n_max + 1);
  boys(n_max, T, F.data());
  const int D = tmax + 1;
  // Rn[n][t][u][v]
  buf.resize((size_t)(n_max + 1) * D * D * D);
  auto at = [&](int n, int t, int u, int v) -> double& {
    return buf[(((size_t)n * D + t) * D + u) * D + v];
  };
  double fac = 1.0;
  for (int n = 0; n <= n_max; ++n) {
    at(n, 0, 0, 0) = fac * F[n];
    fac *= -2.0 * p;
  }
  for (int t = 1; t <= tmax; ++t)
    for (int n = 0; n <= n_max - t; ++n) {
      double v = PC[0] * at(n + 1, t - 1, 0, 0);
      if (t > 1) v += (t - 1) * at(n + 1, t - 2, 0, 0);
      at(n, t, 0, 0) = v;
    }
  for (int u = 1; u <= tmax; ++u)
    for (int t = 0; t <= tmax; ++t)
      for (int n = 0; n <= n_max - t - u; ++n) {
        double v = PC[1] * at(n + 1, t, u - 1, 0);
        if (u > 1) v += (u - 1) * at(n + 1, t, u - 2, 0);
        at(n, t, u, 0) = v;
      }
  for (int vv = 1; vv <= tmax; ++vv)
    for (int u = 0; u <= tmax; ++u)
      for (int t = 0; t <= tmax; ++t)
        for (int n = 0; n <= n_max - t - u - vv; ++n) {
          double v = PC[2] * at(n + 1, t, u, vv - 1);
          if (vv > 1) v += (vv - 1) * at(n + 1, t, u, vv - 2);
          at(n, t, u, vv) = v;
        }
  for (int t = 0; t <= tmax; ++t)
    for (int u = 0; u <= tmax; ++u)
      for (int v = 0; v <= tmax; ++v)
        R[((size_t)t * D + u) * D + v] = at(0, t, u, v);
}

struct ShellRef {
  int atom, l;
  const double* exps;
  const double* coefs;
  int nprim;
  int ao_off;  // spherical AO offset
};

}  // namespace

extern "C" int x2_one_electron(
    int natoms, const int64_t* Z, const double* xyz, int nshells,
    const int64_t* shell_atom, const int64_t* shell_l,
    const int64_t* prim_off, const int64_t* prim_cnt, const double* exps,
    const double* coefs, int nao, double* S, double* T, double* V) {
  std::vector<ShellRef> shells(nshells);
  {
    int off = 0;
    for (int s = 0; s < nshells; ++s) {
      int l = (int)shell_l[s];
      if (l > LMAX) return 1;
      shells[s] = {(int)shell_atom[s], l, exps + prim_off[s],
                   coefs + prim_off[s], (int)prim_cnt[s], off};
      off += nsph(l);
    }
    if (off != nao) return 2;
  }
  std::vector<double> sphC[LMAX + 1];
  std::vector<Mono> mons[LMAX + 1];
  for (int l = 0; l <= LMAX; ++l) {
    sph_coeffs(l, sphC[l]);
    monomials(l, mons[l]);
  }

  std::memset(S, 0, sizeof(double) * nao * nao);
  std::memset(T, 0, sizeof(double) * nao * nao);
  std::memset(V, 0, sizeof(double) * nao * nao);

  // actual max nuclear charge for the screening majorant (a literal
  // Z_max=9 would silently under-screen for elements heavier than F)
  double Zmax = 0.0;
  for (int ic = 0; ic < natoms; ++ic)
    Zmax = std::max(Zmax, std::abs((double)Z[ic]));

  // flatten (i >= j) shell-pair list for parallelism
  std::vector<std::pair<int, int>> pairs;
  pairs.reserve((size_t)nshells * (nshells + 1) / 2);
  for (int i = 0; i < nshells; ++i)
    for (int j = 0; j <= i; ++j) pairs.push_back({i, j});

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 8)
#endif
  for (int64_t pidx = 0; pidx < (int64_t)pairs.size(); ++pidx) {
    const ShellRef& sa = shells[pairs[pidx].first];
    const ShellRef& sb = shells[pairs[pidx].second];
    const double* A = xyz + 3 * sa.atom;
    const double* B = xyz + 3 * sb.atom;
    const int la = sa.l, lb = sb.l;
    const int nca = ncart(la), ncb = ncart(lb);
    std::vector<double> Sc((size_t)nca * ncb, 0.0), Tc(Sc), Vc(Sc);
    Etab Ex, Ey, Ez, Vx, Vy, Vz;
    const int tmax = la + lb;
    const int D = tmax + 1;
    std::vector<double> R((size_t)D * D * D);
    std::vector<double> Fscr, Rscr;  // hermite_R scratch, reused
    const double AB2 = (A[0] - B[0]) * (A[0] - B[0]) +
                       (A[1] - B[1]) * (A[1] - B[1]) +
                       (A[2] - B[2]) * (A[2] - B[2]);

    for (int ip = 0; ip < sa.nprim; ++ip) {
      for (int jp = 0; jp < sb.nprim; ++jp) {
        const double a = sa.exps[ip], b = sb.exps[jp];
        const double w = sa.coefs[ip] * sb.coefs[jp];
        const double p = a + b;
        const double pref = std::pow(M_PI / p, 1.5);
        // primitive screening: every S/T/V term carries the Gaussian
        // product factor exp(-q|AB|^2) through the E-table products. The
        // E coefficients additionally grow at most polynomially
        // (|XPA|,|XPB| <= |AB|, degree <= la+lb+4 incl. the kinetic j+2
        // shift and its b^2 prefactor), so the skip bound folds in a
        // (1+AB^2)^((la+lb+4)/2) majorant, a kinetic-coefficient bound
        // 1 + 2b^2 + b(2*lb+1) + lb(lb-1)/2 (sum of the |t1| term
        // coefficients at j <= lb — strictly covers d/f shells), and a
        // natoms*Z_max nuclear-attraction scale with Z_max taken from
        // the actual Z array. Kills tight-core primitive pairs beyond
        // ~1 bohr and anything truly remote; verified to change S/T/V
        // by < 1e-12 elementwise (tests/test_integrals.py).
        const double Kab = std::exp(-a * b / p * AB2);
        const double poly = std::pow(1.0 + AB2, 0.5 * (la + lb + 4));
        const double kin = 1.0 + 2.0 * b * b + b * (2.0 * lb + 1.0) +
                           0.5 * lb * (lb - 1.0);
        const double majorant = std::abs(w) * Kab * poly * kin *
                                (pref + 2.0 * M_PI / p * natoms * Zmax);
        if (majorant < 1e-16) continue;
        hermite_E(la, lb + 2, a, b, A[0] - B[0], Ex);
        hermite_E(la, lb + 2, a, b, A[1] - B[1], Ey);
        hermite_E(la, lb + 2, a, b, A[2] - B[2], Ez);

        auto s1 = [](const Etab& E, int i, int j) {
          return j >= 0 ? E.at(0, i, j) : 0.0;
        };
        auto t1 = [&](const Etab& E, int i, int j) {
          double v = -2.0 * b * b * s1(E, i, j + 2) +
                     b * (2 * j + 1) * s1(E, i, j);
          if (j >= 2) v -= 0.5 * j * (j - 1) * s1(E, i, j - 2);
          return v;
        };
        for (int ai = 0; ai < nca; ++ai) {
          const Mono ma = mons[la][ai];
          for (int bi = 0; bi < ncb; ++bi) {
            const Mono mb = mons[lb][bi];
            const double sx = s1(Ex, ma.x, mb.x), sy = s1(Ey, ma.y, mb.y),
                         sz = s1(Ez, ma.z, mb.z);
            Sc[(size_t)ai * ncb + bi] += w * sx * sy * sz * pref;
            Tc[(size_t)ai * ncb + bi] +=
                w * pref *
                (t1(Ex, ma.x, mb.x) * sy * sz + sx * t1(Ey, ma.y, mb.y) * sz +
                 sx * sy * t1(Ez, ma.z, mb.z));
          }
        }

        // nuclear attraction
        double P[3] = {(a * A[0] + b * B[0]) / p, (a * A[1] + b * B[1]) / p,
                       (a * A[2] + b * B[2]) / p};
        const double vpref = 2.0 * M_PI / p * w;
        for (int ic = 0; ic < natoms; ++ic) {
          const double PC[3] = {P[0] - xyz[3 * ic], P[1] - xyz[3 * ic + 1],
                                P[2] - xyz[3 * ic + 2]};
          hermite_R(tmax, p, PC, R.data(), Fscr, Rscr);
          const double zc = (double)Z[ic];
          for (int ai = 0; ai < nca; ++ai) {
            const Mono ma = mons[la][ai];
            for (int bi = 0; bi < ncb; ++bi) {
              const Mono mb = mons[lb][bi];
              double acc = 0.0;
              for (int t = 0; t <= ma.x + mb.x; ++t) {
                const double Et = Ex.at(t, ma.x, mb.x);
                if (Et == 0.0) continue;
                for (int u = 0; u <= ma.y + mb.y; ++u) {
                  const double Eu = Ey.at(u, ma.y, mb.y);
                  if (Eu == 0.0) continue;
                  for (int v = 0; v <= ma.z + mb.z; ++v) {
                    const double Ev = Ez.at(v, ma.z, mb.z);
                    if (Ev == 0.0) continue;
                    acc += Et * Eu * Ev * R[((size_t)t * D + u) * D + v];
                  }
                }
              }
              Vc[(size_t)ai * ncb + bi] -= vpref * zc * acc;
            }
          }
        }
      }
    }

    // cart -> spherical: out = Ca * blk * Cb^T
    const int nsa = nsph(la), nsb = nsph(lb);
    const double* Ca = sphC[la].data();
    const double* Cb = sphC[lb].data();
    auto emit = [&](const std::vector<double>& blk, double* M) {
      for (int i = 0; i < nsa; ++i)
        for (int j = 0; j < nsb; ++j) {
          double acc = 0.0;
          for (int ai = 0; ai < nca; ++ai) {
            const double cai = Ca[(size_t)i * nca + ai];
            if (cai == 0.0) continue;
            for (int bi = 0; bi < ncb; ++bi)
              acc += cai * blk[(size_t)ai * ncb + bi] *
                     Cb[(size_t)j * ncb + bi];
          }
          M[(size_t)(sa.ao_off + i) * nao + (sb.ao_off + j)] = acc;
          M[(size_t)(sb.ao_off + j) * nao + (sa.ao_off + i)] = acc;
        }
    };
    emit(Sc, S);
    emit(Tc, T);
    emit(Vc, V);
  }
  return 0;
}
