// Independent C++ float32 oracle for the barotropic reference pipeline.
//
// Purpose: the repo's correctness chain bottoms out in
// oracle/reference_cpu.py, a numpy transcription of the reference
// main.cpp. FFTW3f cannot be installed or vendored in an offline
// environment, so this
// program closes the loop a different way: a SECOND, fully independent
// implementation — different language (C++17), different FFT (hand-written
// iterative radix-2 Cooley-Tukey, single precision, no shared code or
// library with numpy/pocketfft/XLA) — of exactly the reference numerics:
//   * r2c/c2r 2-D transforms with FFTW's conventions: forward unnormalized,
//     inverse divided by nx*ny by hand (main.cpp:37-41, 126-135)
//   * positive-Nyquist gradient tables (fftwfop.cpp:14-24)
//   * Laplacian / inversion with mean-mode passthrough (fftwfop.cpp:39-54,
//     112-117)
//   * circular dealias mask, kc=ceil(N/3) (fftwfop.cpp:56-68)
//   * RK4 with per-stage dealiased tendencies (main.cpp:286-317)
//   * record-before-update output contract vort_step_N.bin (main.cpp:266-282)
// Agreement of this program with the numpy oracle and the JAX model on the
// BASELINE config #1 trajectory (256^2 gaussian, 100 steps) is then evidence
// that the numerics contract is implemented right, not merely transcribed
// consistently (tests/test_c_oracle.py).
//
// Build: make -C native ref_oracle.out   (plain g++ -O2, no dependencies)
// Usage: ref_oracle.out nx ny lx ly dt nu steps record_step init.bin outdir

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

using cfloat = std::complex<float>;

// ---------------------------------------------------------------------------
// 1-D iterative radix-2 DIT FFT, single precision butterflies, twiddles
// rounded from double trig. sign=-1: forward (FFTW/numpy convention),
// sign=+1: inverse (unnormalized).
// ---------------------------------------------------------------------------
struct FFT1D {
  int n;
  std::vector<int> rev;
  std::vector<cfloat> tw_fwd, tw_inv;  // twiddles per stage, concatenated

  explicit FFT1D(int n_) : n(n_) {
    if (n & (n - 1)) { std::fprintf(stderr, "FFT size must be power of 2\n"); std::exit(2); }
    rev.resize(n);
    int lg = 0; while ((1 << lg) < n) ++lg;
    for (int i = 0; i < n; ++i) {
      int r = 0;
      for (int b = 0; b < lg; ++b) r |= ((i >> b) & 1) << (lg - 1 - b);
      rev[i] = r;
    }
    for (int len = 2; len <= n; len <<= 1) {
      for (int k = 0; k < len / 2; ++k) {
        double ang = -2.0 * M_PI * k / len;
        tw_fwd.push_back(cfloat((float)std::cos(ang), (float)std::sin(ang)));
        tw_inv.push_back(cfloat((float)std::cos(-ang), (float)std::sin(-ang)));
      }
    }
  }

  void run(cfloat* a, int sign) const {
    for (int i = 0; i < n; ++i)
      if (rev[i] > i) std::swap(a[i], a[rev[i]]);
    const std::vector<cfloat>& tw = (sign < 0) ? tw_fwd : tw_inv;
    size_t toff = 0;
    for (int len = 2; len <= n; len <<= 1) {
      int half = len / 2;
      for (int i = 0; i < n; i += len) {
        for (int k = 0; k < half; ++k) {
          cfloat u = a[i + k];
          cfloat t = a[i + k + half] * tw[toff + k];
          a[i + k] = u + t;
          a[i + k + half] = u - t;
        }
      }
      toff += half;
    }
  }
};

// ---------------------------------------------------------------------------
// 2-D r2c / c2r with the FFTW layout: real (nx, ny) x-major, spectral
// (nx, hny) with hny = ny/2+1 (configuration.hpp:28-32).
// ---------------------------------------------------------------------------
struct FFT2D {
  int nx, ny, hny;
  FFT1D fx, fy;
  mutable std::vector<cfloat> rowbuf, colbuf;

  FFT2D(int nx_, int ny_) : nx(nx_), ny(ny_), hny(ny_ / 2 + 1),
                            fx(nx_), fy(ny_), rowbuf(ny_), colbuf(nx_) {}

  // forward r2c, unnormalized (fftwf_plan_dft_r2c_2d semantics)
  void r2c(const float* in, cfloat* spec) const {
    for (int i = 0; i < nx; ++i) {
      for (int j = 0; j < ny; ++j) rowbuf[j] = cfloat(in[(size_t)i * ny + j], 0.0f);
      fy.run(rowbuf.data(), -1);
      for (int j = 0; j < hny; ++j) spec[(size_t)i * hny + j] = rowbuf[j];
    }
    for (int j = 0; j < hny; ++j) {
      for (int i = 0; i < nx; ++i) colbuf[i] = spec[(size_t)i * hny + j];
      fx.run(colbuf.data(), -1);
      for (int i = 0; i < nx; ++i) spec[(size_t)i * hny + j] = colbuf[i];
    }
  }

  // inverse c2r + divide by nx*ny (fftwf_backward_normalize, main.cpp:37-41).
  // Non-destructive (the reference's c2r destroys its input; irrelevant here).
  void c2r(const cfloat* spec, float* out) const {
    std::vector<cfloat> tmp((size_t)nx * hny);
    for (int j = 0; j < hny; ++j) {
      for (int i = 0; i < nx; ++i) colbuf[i] = spec[(size_t)i * hny + j];
      fx.run(colbuf.data(), +1);
      for (int i = 0; i < nx; ++i) tmp[(size_t)i * hny + j] = colbuf[i];
    }
    const float norm = 1.0f / ((float)nx * (float)ny);
    for (int i = 0; i < nx; ++i) {
      // after the x inverse pass each row is Hermitian in j:
      // g[i, ny-j] = conj(g[i, j])
      for (int j = 0; j < hny; ++j) rowbuf[j] = tmp[(size_t)i * hny + j];
      for (int j = hny; j < ny; ++j) rowbuf[j] = std::conj(tmp[(size_t)i * hny + (ny - j)]);
      fy.run(rowbuf.data(), +1);
      for (int j = 0; j < ny; ++j) out[(size_t)i * ny + j] = rowbuf[j].real() * norm;
    }
  }
};

// ---------------------------------------------------------------------------
// Spectral tables (fftwfop.cpp:5-79): float32, positive Nyquist, circular
// dealias mask.
// ---------------------------------------------------------------------------
struct Tables {
  int nx, ny, hny;
  std::vector<float> kx, ky, lap, inv_lap, mask;

  Tables(int nx_, int ny_, double lx, double ly)
      : nx(nx_), ny(ny_), hny(ny_ / 2 + 1),
        kx(nx_), ky(ny_ / 2 + 1),
        lap((size_t)nx_ * (ny_ / 2 + 1)), inv_lap((size_t)nx_ * (ny_ / 2 + 1)),
        mask((size_t)nx_ * (ny_ / 2 + 1)) {
    int half = nx / 2 + 1;
    for (int i = 0; i < half; ++i) kx[i] = (float)(2.0 * M_PI * i / lx);
    for (int i = half; i < nx; ++i) kx[i] = -kx[nx - i];      // fftwfop.cpp:15-19
    for (int j = 0; j < hny; ++j) ky[j] = (float)(2.0 * M_PI * j / ly);

    int kcx = (int)std::ceil(nx / 3.0), kcy = (int)std::ceil(ny / 3.0);
    double kill2 = (double)kcx * kcx + (double)kcy * kcy;     // fftwfop.cpp:56-68
    for (int i = 0; i < nx; ++i) {
      int ir = i < nx - i ? i : nx - i;                        // reflected index
      for (int j = 0; j < hny; ++j) {
        size_t p = (size_t)i * hny + j;
        double l = -((double)kx[i] * kx[i] + (double)ky[j] * ky[j]);
        lap[p] = (float)l;
        inv_lap[p] = (p == 0) ? 1.0f : (float)l;               // fftwfop.cpp:43
        mask[p] = ((double)ir * ir + (double)j * j >= kill2) ? 0.0f : 1.0f;
      }
    }
  }
};

static void gradx(const Tables& t, const cfloat* in, cfloat* out) {
  // out = i*kx*in: (re,im) -> (-im*k, re*k) (fftwfop.cpp:87-94)
  for (int i = 0; i < t.nx; ++i) {
    float k = t.kx[i];
    for (int j = 0; j < t.hny; ++j) {
      size_t p = (size_t)i * t.hny + j;
      out[p] = cfloat(-in[p].imag() * k, in[p].real() * k);
    }
  }
}

static void grady(const Tables& t, const cfloat* in, cfloat* out) {
  for (int i = 0; i < t.nx; ++i)
    for (int j = 0; j < t.hny; ++j) {
      size_t p = (size_t)i * t.hny + j;
      float k = t.ky[j];
      out[p] = cfloat(-in[p].imag() * k, in[p].real() * k);
    }
}

static void write_field(const std::string& path, const float* data, size_t n) {
  FILE* f = std::fopen(path.c_str(), "wb");
  if (!f) { std::fprintf(stderr, "cannot open %s\n", path.c_str()); std::exit(2); }
  std::fwrite(data, sizeof(float), n, f);
  std::fclose(f);
}

int main(int argc, char** argv) {
  if (argc != 11) {
    std::fprintf(stderr,
        "usage: %s nx ny lx ly dt nu steps record_step init.bin outdir\n", argv[0]);
    return 2;
  }
  int nx = std::atoi(argv[1]), ny = std::atoi(argv[2]);
  double lx = std::atof(argv[3]), ly = std::atof(argv[4]);
  float dt = (float)std::atof(argv[5]), nu = (float)std::atof(argv[6]);
  int steps = std::atoi(argv[7]), record_step = std::atoi(argv[8]);
  std::string init = argv[9], outdir = argv[10];

  const size_t grids = (size_t)nx * ny;
  const size_t hgrids = (size_t)nx * (ny / 2 + 1);

  std::vector<float> vort(grids), dvdx(grids), dvdy(grids), u(grids), v(grids),
      dvortdt(grids);
  std::vector<cfloat> vort_c(hgrids), vort_c0(hgrids), tmp_c(hgrids),
      lvort_c(hgrids), psi_c(hgrids), dvortdt_c(hgrids),
      rk1(hgrids), rk2(hgrids), rk3(hgrids), rk4(hgrids);

  FILE* f = std::fopen(init.c_str(), "rb");
  if (!f) { std::fprintf(stderr, "cannot read %s\n", init.c_str()); return 2; }
  if (std::fread(vort.data(), sizeof(float), grids, f) != grids) {
    std::fprintf(stderr, "short read from %s\n", init.c_str()); return 2;
  }
  std::fclose(f);

  FFT2D fft(nx, ny);
  Tables t(nx, ny, lx, ly);

  // getDvortdt (main.cpp:146-244); vort_src is identically zero (the
  // unforced main.out path; SURVEY.md §5.10-1 zero-init decision)
  auto rhs = [&](const std::vector<cfloat>& vc, std::vector<cfloat>& out) {
    for (size_t p = 0; p < hgrids; ++p) lvort_c[p] = vc[p] * t.lap[p];
    gradx(t, vc.data(), tmp_c.data()); fft.c2r(tmp_c.data(), dvdx.data());
    grady(t, vc.data(), tmp_c.data()); fft.c2r(tmp_c.data(), dvdy.data());
    for (size_t p = 0; p < hgrids; ++p) psi_c[p] = vc[p] / t.inv_lap[p];
    grady(t, psi_c.data(), tmp_c.data()); fft.c2r(tmp_c.data(), u.data());
    for (size_t p = 0; p < grids; ++p) u[p] = -u[p];
    gradx(t, psi_c.data(), tmp_c.data()); fft.c2r(tmp_c.data(), v.data());
    for (size_t p = 0; p < grids; ++p)
      dvortdt[p] = -u[p] * dvdx[p] - v[p] * dvdy[p];           // main.cpp:225-227
    fft.r2c(dvortdt.data(), out.data());                       // main.cpp:237
    for (size_t p = 0; p < hgrids; ++p) out[p] += lvort_c[p] * nu;
  };
  auto dealias = [&](std::vector<cfloat>& a) {
    for (size_t p = 0; p < hgrids; ++p) a[p] *= t.mask[p];
  };

  fft.r2c(vort.data(), vort_c.data());                         // main.cpp:256
  char name[4096];
  for (int step = 0; step < steps; ++step) {
    if (record_step > 0 && step % record_step == 0) {          // main.cpp:266-282
      fft.c2r(vort_c.data(), vort.data());
      std::snprintf(name, sizeof name, "%s/vort_step_%d.bin", outdir.c_str(), step);
      write_field(name, vort.data(), grids);
    }
    vort_c0 = vort_c;                                          // main.cpp:286
    rhs(vort_c, rk1); dealias(rk1);
    for (size_t p = 0; p < hgrids; ++p) vort_c[p] = vort_c0[p] + rk1[p] * (dt / 2.0f);
    rhs(vort_c, rk2); dealias(rk2);
    for (size_t p = 0; p < hgrids; ++p) vort_c[p] = vort_c0[p] + rk2[p] * (dt / 2.0f);
    rhs(vort_c, rk3); dealias(rk3);
    for (size_t p = 0; p < hgrids; ++p) vort_c[p] = vort_c0[p] + rk3[p] * dt;
    rhs(vort_c, rk4); dealias(rk4);
    for (size_t p = 0; p < hgrids; ++p)                        // main.cpp:309-312
      vort_c[p] = vort_c0[p]
          + (rk1[p] + 2.0f * rk2[p] + 2.0f * rk3[p] + rk4[p]) * (dt / 6.0f);
  }
  fft.c2r(vort_c.data(), vort.data());
  std::snprintf(name, sizeof name, "%s/vort_final.bin", outdir.c_str());
  write_field(name, vort.data(), grids);
  return 0;
}
