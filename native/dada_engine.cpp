// Native DADA I/O engine.
//
// The host-side hot path of the framework: DADA files store TFP-ordered
// interleaved re/im samples (int8/int16/float32/float64); the device compute
// path wants split-complex float32 planes in PFT order. This engine does
// the mmap'd read + dtype conversion + corner turn (and the reverse for
// writes, including int8/int16 requantization) with a thread pool — the
// role the reference delegates to Matlab I/O + the external psr_formats
// package (read_dada_file.m, write_dada_data.m:28-56,
// reshape_dada_data.m:16-27, reshape_low_cbf_data.m:24-56).
//
// Exposed as a plain C ABI consumed via ctypes (ska_pst_dsp.io.native).

#include <algorithm>
#include <functional>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

int n_threads() {
  unsigned hc = std::thread::hardware_concurrency();
  return hc ? static_cast<int>(std::min(hc, 16u)) : 4;
}

void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  int nt = n_threads();
  if (n < (1 << 16) || nt <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}

struct MappedFile {
  int fd = -1;
  const uint8_t* data = nullptr;
  int64_t size = 0;

  bool open(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) return false;
    size = st.st_size;
    data = static_cast<const uint8_t*>(
        mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
    return data != MAP_FAILED;
  }
  ~MappedFile() {
    if (data && data != MAP_FAILED) munmap(const_cast<uint8_t*>(data), size);
    if (fd >= 0) close(fd);
  }
};

template <typename T>
void convert_tfp_to_pft(const T* src, float* out_re, float* out_im,
                        int64_t count, int64_t npol, int64_t nchan) {
  // src: TFP interleaved complex: index = ((t*nchan + f)*npol + p)*2 + {0,1}
  // dst: PFT planes: index = (p*nchan + f)*count + t
  parallel_for(count, [&](int64_t t0, int64_t t1) {
    for (int64_t t = t0; t < t1; ++t) {
      const T* row = src + (t * nchan * npol) * 2;
      for (int64_t f = 0; f < nchan; ++f) {
        for (int64_t p = 0; p < npol; ++p) {
          const T* s = row + (f * npol + p) * 2;
          int64_t d = (p * nchan + f) * count + t;
          out_re[d] = static_cast<float>(s[0]);
          out_im[d] = static_cast<float>(s[1]);
        }
      }
    }
  });
}

template <typename T>
void convert_pft_to_tfp(const float* re, const float* im, T* dst,
                        int64_t count, int64_t npol, int64_t nchan,
                        float scale, float lo, float hi, bool quantize) {
  parallel_for(count, [&](int64_t t0, int64_t t1) {
    for (int64_t t = t0; t < t1; ++t) {
      T* row = dst + (t * nchan * npol) * 2;
      for (int64_t f = 0; f < nchan; ++f) {
        for (int64_t p = 0; p < npol; ++p) {
          int64_t s = (p * nchan + f) * count + t;
          float vr = re[s] * scale;
          float vi = im[s] * scale;
          if (quantize) {
            vr = std::min(std::max(std::nearbyint(vr), lo), hi);
            vi = std::min(std::max(std::nearbyint(vi), lo), hi);
          }
          T* d = row + (f * npol + p) * 2;
          d[0] = static_cast<T>(vr);
          d[1] = static_cast<T>(vi);
        }
      }
    }
  });
}

}  // namespace

extern "C" {

// Scan the ASCII header for HDR_SIZE; returns the header size in bytes or -1.
int64_t dada_header_size(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  char buf[65536];
  size_t n = fread(buf, 1, sizeof(buf) - 1, f);
  fclose(f);
  buf[n] = 0;
  const char* k = strstr(buf, "HDR_SIZE");
  if (!k) return -1;
  return strtoll(k + 8, nullptr, 10);
}

// Read `count` time samples starting at `start` into split PFT float planes.
// nbit: 8/16 (int) or 32/64 (float). Returns 0 on success.
int dada_read_split(const char* path, int64_t hdr_size, int64_t npol,
                    int64_t nchan, int nbit, int64_t start, int64_t count,
                    float* out_re, float* out_im) {
  MappedFile mf;
  if (!mf.open(path)) return 1;
  int64_t bytes_per_word = nbit / 8;
  int64_t words_per_samp = npol * nchan * 2;
  int64_t offset = hdr_size + start * words_per_samp * bytes_per_word;
  int64_t need = count * words_per_samp * bytes_per_word;
  if (offset + need > mf.size) return 2;
  const uint8_t* base = mf.data + offset;
  switch (nbit) {
    case 8:
      convert_tfp_to_pft(reinterpret_cast<const int8_t*>(base), out_re,
                         out_im, count, npol, nchan);
      break;
    case 16:
      convert_tfp_to_pft(reinterpret_cast<const int16_t*>(base), out_re,
                         out_im, count, npol, nchan);
      break;
    case 32:
      convert_tfp_to_pft(reinterpret_cast<const float*>(base), out_re, out_im,
                         count, npol, nchan);
      break;
    case 64:
      convert_tfp_to_pft(reinterpret_cast<const double*>(base), out_re,
                         out_im, count, npol, nchan);
      break;
    default:
      return 3;
  }
  return 0;
}

// Append `count` samples of split PFT float planes as TFP records.
// nbit 8/16 quantizes (round + clip) after scaling. Returns 0 on success.
int dada_write_split(const char* path, int64_t npol, int64_t nchan, int nbit,
                     int64_t count, const float* re, const float* im,
                     float scale) {
  int64_t words = count * npol * nchan * 2;
  std::vector<uint8_t> buf;
  switch (nbit) {
    case 8: {
      buf.resize(words);
      convert_pft_to_tfp(re, im, reinterpret_cast<int8_t*>(buf.data()), count,
                         npol, nchan, scale, -128.f, 127.f, true);
      break;
    }
    case 16: {
      buf.resize(words * 2);
      convert_pft_to_tfp(re, im, reinterpret_cast<int16_t*>(buf.data()),
                         count, npol, nchan, scale, -32768.f, 32767.f, true);
      break;
    }
    case 32: {
      buf.resize(words * 4);
      convert_pft_to_tfp(re, im, reinterpret_cast<float*>(buf.data()), count,
                         npol, nchan, scale, 0.f, 0.f, false);
      break;
    }
    default:
      return 3;
  }
  FILE* f = fopen(path, "ab");
  if (!f) return 1;
  size_t wrote = fwrite(buf.data(), 1, buf.size(), f);
  fclose(f);
  return wrote == buf.size() ? 0 : 2;
}

// LowCBF heap stream (32-sample heaps, FPT packets, t fastest) -> PFT planes.
int lowcbf_read_split(const char* path, int64_t hdr_size, int64_t npol,
                      int64_t nchan, int nbit, int64_t start_heap,
                      int64_t n_heaps, float* out_re, float* out_im) {
  const int64_t T = 32;
  MappedFile mf;
  if (!mf.open(path)) return 1;
  int64_t bpw = nbit / 8;
  int64_t words_per_heap = T * npol * nchan * 2;
  int64_t offset = hdr_size + start_heap * words_per_heap * bpw;
  if (offset + n_heaps * words_per_heap * bpw > mf.size) return 2;
  if (nbit != 16 && nbit != 32 && nbit != 8) return 3;
  int64_t nsamp = n_heaps * T;
  parallel_for(n_heaps, [&](int64_t h0, int64_t h1) {
    for (int64_t h = h0; h < h1; ++h) {
      const uint8_t* heap = mf.data + offset + h * words_per_heap * bpw;
      for (int64_t f = 0; f < nchan; ++f) {
        for (int64_t p = 0; p < npol; ++p) {
          for (int64_t t = 0; t < T; ++t) {
            // heap index: ((f*npol + p)*T + t)*2
            int64_t si = ((f * npol + p) * T + t) * 2;
            float vr, vi;
            if (nbit == 32) {
              const float* s = reinterpret_cast<const float*>(heap) + si;
              vr = s[0]; vi = s[1];
            } else if (nbit == 16) {
              const int16_t* s = reinterpret_cast<const int16_t*>(heap) + si;
              vr = s[0]; vi = s[1];
            } else {
              const int8_t* s = reinterpret_cast<const int8_t*>(heap) + si;
              vr = s[0]; vi = s[1];
            }
            int64_t d = (p * nchan + f) * nsamp + h * T + t;
            out_re[d] = vr;
            out_im[d] = vi;
          }
        }
      }
    }
  });
  return 0;
}

}  // extern "C"
