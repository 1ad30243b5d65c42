// Native host-side runtime for rte_rrtmgp_nn_tpu.
//
// The reference's runtime around its compute kernels is native (Fortran):
// netCDF I/O helpers (mo_simple_netcdf.F90, easy_netcdf.F90) and an
// OpenMP-threaded block loop staging inputs for the kernels
// (rrtmgp_rfmip_lw.F90:364-446). This library is this framework's
// equivalent: a dependency-free classic-netCDF (CDF-1/CDF-2) reader/writer
// and multithreaded NN-input feature packing (the host side of
// compute_nn_inputs: log/quarter-root power scalings + min-max
// normalization, mo_gas_optics_rrtmgp.F90:713-721), producing
// device-ready float32 blocks for the streaming pipeline.
//
// C ABI only; bound from Python with ctypes (utils/native.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <cstdlib>
#include <string>
#include <vector>
#include <memory>
#include <map>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// Classic netCDF (CDF-1/CDF-2) parsing
// ---------------------------------------------------------------------------

struct NcVar {
  std::string name;
  std::vector<int> dim_ids;
  int type = 0;      // 1=byte 2=char 3=short 4=int 5=float 6=double
  uint64_t vsize = 0;
  uint64_t begin = 0;
};

struct NcFile {
  std::vector<uint64_t> dim_sizes;
  std::vector<std::string> dim_names;
  std::vector<NcVar> vars;
  std::vector<uint8_t> data;  // whole file
  int version = 1;            // 1 = CDF-1 (32-bit offsets), 2 = CDF-2
};

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;
  uint32_t u32() {
    if (p + 4 > end) { ok = false; return 0; }
    uint32_t v = (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
                 (uint32_t(p[2]) << 8) | uint32_t(p[3]);
    p += 4;
    return v;
  }
  uint64_t u64() {
    uint64_t hi = u32();
    uint64_t lo = u32();
    return (hi << 32) | lo;
  }
  std::string name() {
    uint32_t n = u32();
    if (p + n > end) { ok = false; return {}; }
    std::string s(reinterpret_cast<const char*>(p), n);
    p += (n + 3) & ~3u;  // 4-byte aligned
    return s;
  }
  void skip(uint64_t n) {
    if (p + n > end) { ok = false; return; }
    p += n;
  }
};

int type_size(int t) {
  switch (t) {
    case 1: case 2: return 1;
    case 3: return 2;
    case 4: case 5: return 4;
    case 6: return 8;
  }
  return 0;
}

void skip_attrs(Cursor& c) {
  uint32_t tag = c.u32();
  uint32_t n = c.u32();
  if (tag == 0 && n == 0) return;  // ABSENT
  if (tag != 0x0C) { c.ok = false; return; }  // NC_ATTRIBUTE
  for (uint32_t i = 0; i < n && c.ok; ++i) {
    c.name();
    uint32_t t = c.u32();
    uint32_t cnt = c.u32();
    uint64_t bytes = uint64_t(cnt) * type_size(int(t));
    c.skip((bytes + 3) & ~3ull);
  }
}

bool parse_nc(NcFile& f) {
  Cursor c{f.data.data(), f.data.data() + f.data.size()};
  if (f.data.size() < 8 || memcmp(f.data.data(), "CDF", 3) != 0) return false;
  f.version = f.data[3];
  if (f.version != 1 && f.version != 2) return false;
  c.p += 4;
  c.u32();  // numrecs (record dim unsupported for reads here)
  // dim_list
  uint32_t tag = c.u32(), ndims = c.u32();
  if (!(tag == 0x0A || (tag == 0 && ndims == 0))) return false;
  for (uint32_t i = 0; i < ndims && c.ok; ++i) {
    f.dim_names.push_back(c.name());
    f.dim_sizes.push_back(c.u32());
  }
  skip_attrs(c);  // global attributes
  // var_list
  tag = c.u32();
  uint32_t nvars = c.u32();
  if (!(tag == 0x0B || (tag == 0 && nvars == 0))) return false;
  for (uint32_t i = 0; i < nvars && c.ok; ++i) {
    NcVar v;
    v.name = c.name();
    uint32_t nd = c.u32();
    for (uint32_t d = 0; d < nd; ++d) v.dim_ids.push_back(int(c.u32()));
    skip_attrs(c);
    v.type = int(c.u32());
    v.vsize = c.u32();
    v.begin = (f.version == 2) ? c.u64() : c.u32();
    f.vars.push_back(std::move(v));
  }
  return c.ok;
}

double read_scalar_at(const uint8_t* p, int type) {
  auto be16 = [&]() { return int16_t((p[0] << 8) | p[1]); };
  auto be32 = [&]() {
    return int32_t((uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
                   (uint32_t(p[2]) << 8) | uint32_t(p[3]));
  };
  switch (type) {
    case 1: return double(int8_t(p[0]));
    case 2: return double(p[0]);
    case 3: return double(be16());
    case 4: return double(be32());
    case 5: {
      uint32_t u = uint32_t(be32());
      float fv;
      memcpy(&fv, &u, 4);
      return double(fv);
    }
    case 6: {
      uint64_t u = 0;
      for (int i = 0; i < 8; ++i) u = (u << 8) | p[i];
      double dv;
      memcpy(&dv, &u, 8);
      return dv;
    }
  }
  return 0.0;
}

}  // namespace

extern "C" {

// Opaque handle API -------------------------------------------------------

void* rrtio_open(const char* path) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return nullptr;
  auto f = std::make_unique<NcFile>();
  fseek(fp, 0, SEEK_END);
  long n = ftell(fp);
  fseek(fp, 0, SEEK_SET);
  f->data.resize(size_t(n));
  size_t rd = fread(f->data.data(), 1, size_t(n), fp);
  fclose(fp);
  if (rd != size_t(n) || !parse_nc(*f)) return nullptr;
  return f.release();
}

void rrtio_close(void* h) { delete static_cast<NcFile*>(h); }

// Returns ndim, fills dims (caller provides space for 8); -1 if not found.
int rrtio_var_info(void* h, const char* name, int64_t* dims) {
  auto* f = static_cast<NcFile*>(h);
  for (auto& v : f->vars) {
    if (v.name == name) {
      for (size_t i = 0; i < v.dim_ids.size() && i < 8; ++i)
        dims[i] = int64_t(f->dim_sizes[size_t(v.dim_ids[i])]);
      return int(v.dim_ids.size());
    }
  }
  return -1;
}

int64_t rrtio_dim_size(void* h, const char* name) {
  auto* f = static_cast<NcFile*>(h);
  for (size_t i = 0; i < f->dim_names.size(); ++i)
    if (f->dim_names[i] == name) return int64_t(f->dim_sizes[i]);
  return -1;
}

// Read a variable converted to float64, C (row-major, as stored) order.
// Returns number of elements, or -1.
int64_t rrtio_read_f64(void* h, const char* name, double* out, int64_t cap) {
  auto* f = static_cast<NcFile*>(h);
  for (auto& v : f->vars) {
    if (v.name != name) continue;
    uint64_t count = 1;
    for (int d : v.dim_ids) count *= f->dim_sizes[size_t(d)];
    if (int64_t(count) > cap) return -1;
    int ts = type_size(v.type);
    const uint8_t* p = f->data.data() + v.begin;
    if (v.begin + count * uint64_t(ts) > f->data.size()) return -1;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < int64_t(count); ++i)
      out[i] = read_scalar_at(p + uint64_t(i) * ts, v.type);
    return int64_t(count);
  }
  return -1;
}

// ---------------------------------------------------------------------------
// NN-input feature packing (host side of compute_nn_inputs)
// ---------------------------------------------------------------------------
//
// Inputs (all length ncol*nlay, C order [col][lay], float64):
//   play, tlay, gases[ngas] in the model's input order (h2o first at
//   feature 2, o3 at feature 3 per the convention).
// feature_kind: 0 = raw temperature, 1 = log(play), 2 = x^(1/4), 3 = raw vmr
// Output: float32 (ncol*nlay, nfeat) min-max scaled.

void rrtio_pack_features(
    int64_t nbatch, int32_t nfeat,
    const double* const* columns,   // nfeat pointers, each length nbatch
    const int32_t* feature_kind,    // nfeat
    const float* fmin, const float* fmax,
    float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < nbatch; ++i) {
    for (int32_t k = 0; k < nfeat; ++k) {
      double x = columns[k][i];
      switch (feature_kind[k]) {
        case 1: x = std::log(x); break;
        case 2: x = std::sqrt(std::sqrt(x)); break;
        default: break;
      }
      out[i * nfeat + k] =
          float((x - double(fmin[k])) / (double(fmax[k]) - double(fmin[k])));
    }
  }
}

// Column dry-air amounts [molec/cm2] (get_col_dry,
// mo_gas_optics_rrtmgp.F90:1662-1707), multithreaded over columns.
void rrtio_col_dry(
    int64_t ncol, int32_t nlay,
    const double* vmr_h2o,   // (ncol, nlay)
    const double* plev,      // (ncol, nlay+1)
    double grav, double m_dry, double m_h2o, double avogad,
    double* out) {           // (ncol, nlay)
#pragma omp parallel for schedule(static)
  for (int64_t c = 0; c < ncol; ++c) {
    const double* pv = plev + c * (nlay + 1);
    const double* q = vmr_h2o + c * nlay;
    double* o = out + c * nlay;
    for (int32_t l = 0; l < nlay; ++l) {
      double dp = std::fabs(pv[l] - pv[l + 1]);
      double fact = 1.0 / (1.0 + q[l]);
      double m_air = (m_dry + m_h2o * q[l]) * fact;
      o[l] = 10.0 * dp * avogad * fact / (1000.0 * m_air * 100.0 * grav);
    }
  }
}

int rrtio_n_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
