// Native asynchronous scan loader: the IO worker of the runtime.
//
// Streams KITTI-format velodyne .bin files (float32 x,y,z,reflectance
// records) from a directory with a background prefetch thread, so disk IO
// and float parsing overlap host orchestration and device compute — the
// data-loader role the reference delegates to application code around
// libpointmatcher's DataPoints IO.
//
// C ABI (ctypes-friendly):
//   sl_open(dir, pattern_ext, prefetch_depth, quantize)
//                                             -> handle (>=0) or -1;
//                                                quantize != 0 makes the IO
//                                                worker also build the int16
//                                                millimeter copy per scan
//   sl_count(handle)                          -> number of scans found
//   sl_max_points(handle)                     -> upper bound on points/scan
//   sl_next(handle, out_xyz, out_refl, cap)   -> n points (0 = legitimately
//                                                empty scan), -1 bad handle,
//                                                -2 read failure, -3 end of
//                                                stream
//   sl_next_q(handle, out_xyz_q, cap)         -> n points as int16
//                                                millimeters (quantized by
//                                                the IO worker; points
//                                                beyond +-32.7 m dropped);
//                                                same -1/-2/-3 codes, plus
//                                                -4 = loader opened without
//                                                quantize
//   sl_eos(handle)                            -> 1 when every scan has been
//                                                consumed, else 0
//   sl_close(handle)
//
// A scan whose points were ALL dropped by the int16 envelope (or a file
// that failed to read) must NOT end the stream: end-of-stream is the
// distinct -3 (and sl_eos), so consumers skip pathological scans instead
// of silently truncating the sequence.
//
// The int16 path exists for transfer-bound hosts: LiDAR
// packets are fixed-point to begin with, a 1 mm grid adds 0.5 mm max
// round-off against ~10 mm range noise, and halving the host->device
// bytes directly raises the transfer-bound live-SLAM pipeline floor.
// The conversion runs on the loader's background thread, off the
// consumer's critical path.
//
// Scans are served in lexicographic filename order (KITTI convention).

#include <atomic>
#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <dirent.h>
#include <mutex>
#include <string>
#include <sys/stat.h>
#include <thread>
#include <vector>

namespace {

struct Scan {
  std::vector<float> xyz;      // 3 * n
  std::vector<float> refl;     // n
  std::vector<int16_t> xyz_q;  // 3 * nq, 1 mm grid (quantize-enabled only)
  bool failed = false;         // read error (distinct from a 0-point scan)
};

constexpr float kQuantScale = 1000.0f;            // 1 mm fixed point
constexpr float kQuantMax = 32.7f;                // |coord| bound, meters

void quantize(Scan* s) {
  size_t n = s->refl.size();
  s->xyz_q.clear();
  s->xyz_q.reserve(n * 3);
  for (size_t i = 0; i < n; ++i) {
    float x = s->xyz[3 * i], y = s->xyz[3 * i + 1], z = s->xyz[3 * i + 2];
    if (x > kQuantMax || x < -kQuantMax || y > kQuantMax ||
        y < -kQuantMax || z > kQuantMax || z < -kQuantMax)
      continue;  // out of the int16 envelope: drop (documented)
    s->xyz_q.push_back(static_cast<int16_t>(x * kQuantScale
                                            + (x >= 0 ? 0.5f : -0.5f)));
    s->xyz_q.push_back(static_cast<int16_t>(y * kQuantScale
                                            + (y >= 0 ? 0.5f : -0.5f)));
    s->xyz_q.push_back(static_cast<int16_t>(z * kQuantScale
                                            + (z >= 0 ? 0.5f : -0.5f)));
  }
}

struct Loader {
  std::vector<std::string> files;
  size_t next_file = 0;       // producer cursor
  size_t consumed = 0;        // scans handed to the caller
  size_t max_points = 0;
  size_t depth;
  bool do_quantize = false;   // build xyz_q on the IO thread (sl_next_q
                              // consumers); f32-path consumers skip the
                              // per-scan conversion cost entirely

  std::deque<Scan> queue;     // produced, not yet consumed
  std::mutex mu;
  std::condition_variable cv_produced, cv_consumed;
  std::atomic<bool> stop{false};
  std::thread worker;

  ~Loader() {
    stop.store(true);
    cv_consumed.notify_all();
    if (worker.joinable()) worker.join();
  }
};

std::mutex g_mu;
std::vector<Loader*> g_loaders;

bool read_bin(const std::string& path, Scan* out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long bytes = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  size_t n = static_cast<size_t>(bytes) / (4 * sizeof(float));
  std::vector<float> raw(n * 4);
  size_t got = std::fread(raw.data(), sizeof(float), n * 4, f);
  std::fclose(f);
  if (got != n * 4) return false;
  out->xyz.resize(n * 3);
  out->refl.resize(n);
  for (size_t i = 0; i < n; ++i) {
    out->xyz[3 * i + 0] = raw[4 * i + 0];
    out->xyz[3 * i + 1] = raw[4 * i + 1];
    out->xyz[3 * i + 2] = raw[4 * i + 2];
    out->refl[i] = raw[4 * i + 3];
  }
  return true;
}

void produce(Loader* L) {
  while (!L->stop.load()) {
    size_t idx;
    {
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_consumed.wait(lk, [L] {
        return L->stop.load() || L->queue.size() < L->depth;
      });
      if (L->stop.load() || L->next_file >= L->files.size()) return;
      idx = L->next_file++;
    }
    Scan s;
    bool ok = read_bin(L->files[idx], &s);
    if (ok && L->do_quantize) quantize(&s);  // off the consumer's path
    {
      std::unique_lock<std::mutex> lk(L->mu);
      if (!ok) {
        s = Scan{};
        s.failed = true;
      }
      L->queue.push_back(std::move(s));
    }
    L->cv_produced.notify_one();
  }
}

}  // namespace

extern "C" {

int sl_open(const char* dir, const char* ext, int prefetch_depth,
            int quantize) {
  DIR* d = opendir(dir);
  if (!d) return -1;
  std::vector<std::string> files;
  std::string suffix = ext && ext[0] ? ext : ".bin";
  for (dirent* e = readdir(d); e; e = readdir(d)) {
    std::string name = e->d_name;
    if (name.size() > suffix.size() &&
        name.compare(name.size() - suffix.size(), suffix.size(), suffix)
            == 0) {
      files.push_back(std::string(dir) + "/" + name);
    }
  }
  closedir(d);
  std::sort(files.begin(), files.end());
  if (files.empty()) return -1;

  auto* L = new Loader();
  L->files = std::move(files);
  L->depth = prefetch_depth > 0 ? static_cast<size_t>(prefetch_depth) : 2;
  L->do_quantize = quantize != 0;
  size_t max_bytes = 0;
  for (const auto& f : L->files) {
    struct stat st;
    if (stat(f.c_str(), &st) == 0)
      max_bytes = std::max(max_bytes, static_cast<size_t>(st.st_size));
  }
  L->max_points = max_bytes / (4 * sizeof(float));
  L->worker = std::thread(produce, L);

  std::lock_guard<std::mutex> lk(g_mu);
  g_loaders.push_back(L);
  return static_cast<int>(g_loaders.size()) - 1;
}

static Loader* get(int h) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (h < 0 || h >= static_cast<int>(g_loaders.size())) return nullptr;
  return g_loaders[h];
}

int sl_count(int h) {
  Loader* L = get(h);
  return L ? static_cast<int>(L->files.size()) : -1;
}

long sl_max_points(int h) {
  Loader* L = get(h);
  return L ? static_cast<long>(L->max_points) : -1;
}

// Pops the next produced scan. Returns false at true end-of-stream.
static bool pop_scan(Loader* L, Scan* out) {
  {
    std::unique_lock<std::mutex> lk(L->mu);
    if (L->consumed >= L->files.size()) return false;  // end of stream
    // A claimed-but-unread scan may still be in flight: wait on produced.
    L->cv_produced.wait(lk, [L] { return !L->queue.empty(); });
    *out = std::move(L->queue.front());
    L->queue.pop_front();
    L->consumed++;
  }
  L->cv_consumed.notify_one();
  return true;
}

long sl_next(int h, float* out_xyz, float* out_refl, long cap) {
  Loader* L = get(h);
  if (!L) return -1;
  Scan s;
  if (!pop_scan(L, &s)) return -3;  // end of stream (distinct from n=0)
  if (s.failed) return -2;
  long n = static_cast<long>(s.refl.size());
  if (n > cap) n = cap;
  std::memcpy(out_xyz, s.xyz.data(), static_cast<size_t>(n) * 3
              * sizeof(float));
  if (out_refl)
    std::memcpy(out_refl, s.refl.data(), static_cast<size_t>(n)
                * sizeof(float));
  return n;
}

long sl_next_q(int h, int16_t* out_xyz_q, long cap) {
  Loader* L = get(h);
  if (!L) return -1;
  if (!L->do_quantize) return -4;  // opened without quantize
  Scan s;
  if (!pop_scan(L, &s)) return -3;  // end of stream (distinct from n=0:
                                    // an all-dropped scan must not
                                    // truncate the sequence)
  if (s.failed) return -2;
  long n = static_cast<long>(s.xyz_q.size() / 3);
  if (n > cap) n = cap;
  std::memcpy(out_xyz_q, s.xyz_q.data(),
              static_cast<size_t>(n) * 3 * sizeof(int16_t));
  return n;
}

int sl_eos(int h) {
  Loader* L = get(h);
  if (!L) return 1;
  std::lock_guard<std::mutex> lk(L->mu);
  return L->consumed >= L->files.size() ? 1 : 0;
}

void sl_close(int h) {
  std::lock_guard<std::mutex> lk(g_mu);
  if (h < 0 || h >= static_cast<int>(g_loaders.size())) return;
  delete g_loaders[h];
  g_loaders[h] = nullptr;
}

}  // extern "C"
