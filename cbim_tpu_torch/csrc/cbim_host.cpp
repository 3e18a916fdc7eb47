// The host-window batch assembler of the training input pipeline: a small
// C++ library with a persistent thread pool, bound with ctypes
// (cbim_tpu_torch/data/native.py).  The port's copy of the JAX package's
// native/cbim_host.cpp, written for the port's host tensors: it fills this
// rank's rows of the pinned image (float32) and label (int8) batch tensors
// in place, and splits every sample into slabs of buffer planes so that a
// batch of 2 keeps every pool thread busy.
//
// native.py builds it on first use with
//   g++ -O3 -std=c++17 -fPIC -shared -pthread
// into build/host/ at the repository root.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

class ThreadPool {
 public:
  explicit ThreadPool(int n) : stop_(false), pending_(0) {
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(mu_);
            cv_.wait(lk, [this] { return stop_ || !jobs_.empty(); });
            if (stop_ && jobs_.empty()) return;
            job = std::move(jobs_.front());
            jobs_.pop();
          }
          job();
          if (pending_.fetch_sub(1) == 1) {
            std::unique_lock<std::mutex> lk(done_mu_);
            done_cv_.notify_all();
          }
        }
      });
    }
  }

  ~ThreadPool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& w : workers_) w.join();
  }

  int size() const { return static_cast<int>(workers_.size()); }

  void submit(std::function<void()> job) {
    pending_.fetch_add(1);
    {
      std::unique_lock<std::mutex> lk(mu_);
      jobs_.push(std::move(job));
    }
    cv_.notify_one();
  }

  void wait() {
    std::unique_lock<std::mutex> lk(done_mu_);
    done_cv_.wait(lk, [this] { return pending_.load() == 0; });
  }

 private:
  std::vector<std::thread> workers_;
  std::queue<std::function<void()>> jobs_;
  std::mutex mu_, done_mu_;
  std::condition_variable cv_, done_cv_;
  std::atomic<int> pending_;
  bool stop_;
};

// dst planes [p0, p1) of one sample's (bd, bh, bw) buffer: zeros, then the
// rows of src[z0:z0+wz, y0:y0+wy, x0:x0+wx] (a D x H x W row-major volume)
// that land there, at offsets (oz, oy, ox)
template <typename T>
void copy_slab(const T* src, int64_t H, int64_t W, const int64_t* w, T* dst,
               int64_t bh, int64_t bw, int64_t p0, int64_t p1) {
  std::memset(dst + p0 * bh * bw, 0, sizeof(T) * (p1 - p0) * bh * bw);
  const int64_t z_lo = std::max<int64_t>(p0 - w[6], 0);
  const int64_t z_hi = std::min<int64_t>(p1 - w[6], w[3]);
  for (int64_t z = z_lo; z < z_hi; ++z) {
    const T* src_z = src + (w[0] + z) * H * W;
    T* dst_z = dst + (w[6] + z) * bh * bw;
    for (int64_t y = 0; y < w[4]; ++y) {
      std::memcpy(dst_z + (w[7] + y) * bw + w[8],
                  src_z + (w[1] + y) * W + w[2], sizeof(T) * w[5]);
    }
  }
}

}  // namespace

extern "C" {

void* cbim_pool_create(int n_threads) {
  return new ThreadPool(std::max(n_threads, 1));
}

void cbim_pool_destroy(void* pool) { delete static_cast<ThreadPool*>(pool); }

// Assemble the precrop windows of a batch in parallel.
//  srcs_img:  B pointers to float32 (D, H, W) volumes
//  srcs_lab:  B pointers to int8 (D, H, W) label volumes
//  dims:      B*3 int64 (D, H, W) per sample
//  windows:   B*9 int64 per sample: z0, y0, x0, wz, wy, wx, oz, oy, ox
//  dst_img:   (B, bd, bh, bw) float32 out
//  dst_lab:   (B, bd, bh, bw) int8 out
int cbim_assemble_batch(void* pool_ptr, int64_t batch,
                        const float** srcs_img, const int8_t** srcs_lab,
                        const int64_t* dims, const int64_t* windows,
                        int64_t bd, int64_t bh, int64_t bw,
                        float* dst_img, int8_t* dst_lab) {
  auto* pool = static_cast<ThreadPool*>(pool_ptr);
  if (batch <= 0) return 0;
  const int64_t buf = bd * bh * bw;
  const int64_t slabs = std::min<int64_t>(
      bd, std::max<int64_t>(1, (pool->size() + batch - 1) / batch));
  for (int64_t i = 0; i < batch; ++i) {
    for (int64_t s = 0; s < slabs; ++s) {
      const int64_t p0 = bd * s / slabs, p1 = bd * (s + 1) / slabs;
      pool->submit([=] {
        const int64_t* d = dims + i * 3;
        const int64_t* w = windows + i * 9;
        copy_slab<float>(srcs_img[i], d[1], d[2], w, dst_img + i * buf, bh,
                         bw, p0, p1);
        copy_slab<int8_t>(srcs_lab[i], d[1], d[2], w, dst_lab + i * buf, bh,
                          bw, p0, p1);
      });
    }
  }
  pool->wait();
  return 0;
}

}  // extern "C"
