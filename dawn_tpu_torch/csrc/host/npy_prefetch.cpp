// Threaded chunked-.npy reader: the host side of the training input pipeline.
//
// Training reads directories of 25-frame chunk_%04d.npy blocks, one per video
// and modality. A pool of C++ threads parses each file's npy header, reads the
// payload into its own buffer and keeps a bounded queue of finished blocks
// ahead of the consumer, so the file reads of a batch overlap one another and
// the device step (dawn_tpu_torch/train/data.py: NativeChunkReader).
//
// C interface (ctypes, dawn_tpu_torch/runtime/native.py):
//   dawn_npy_read(path, out, cap)            -> payload bytes copied (header stripped)
//   dawn_prefetch_create(n_threads, qcap)    -> handle
//   dawn_prefetch_submit(h, path, tag)       -> queue a read
//   dawn_prefetch_next(h, out, cap, tag*)    -> blocking dequeue of a finished read
//   dawn_prefetch_destroy(h)
//
// Built by dawn_tpu_torch/build.py with g++ -O3 -fPIC -std=c++17 -shared -pthread.

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// Parse the npy v1/v2 header; returns payload offset or -1.
int64_t npy_payload_offset(FILE* f) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return -1;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return -1;
  int major = magic[6];
  uint32_t hlen = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return -1;
    hlen = b[0] | (b[1] << 8);
    return 10 + hlen;
  }
  unsigned char b[4];
  if (fread(b, 1, 4, f) != 4) return -1;
  hlen = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
  return 12 + hlen;
}

struct Item {
  std::string path;
  int64_t tag;
  std::vector<uint8_t> data;
  bool ok;
};

struct Prefetcher {
  std::vector<std::thread> workers;
  std::deque<std::pair<std::string, int64_t>> pending;
  std::deque<Item> done;
  std::mutex mu;
  std::condition_variable cv_pending, cv_done;
  size_t qcap;
  bool stop = false;

  explicit Prefetcher(int n_threads, size_t queue_cap) : qcap(queue_cap) {
    for (int i = 0; i < n_threads; ++i) {
      workers.emplace_back([this] { this->run(); });
    }
  }

  void run() {
    for (;;) {
      std::pair<std::string, int64_t> job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_pending.wait(lk, [&] { return stop || (!pending.empty() && done.size() < qcap); });
        if (stop) return;
        job = pending.front();
        pending.pop_front();
      }
      Item item;
      item.path = job.first;
      item.tag = job.second;
      item.ok = false;
      FILE* f = fopen(job.first.c_str(), "rb");
      if (f) {
        int64_t off = npy_payload_offset(f);
        if (off >= 0) {
          fseek(f, 0, SEEK_END);
          long end = ftell(f);
          fseek(f, off, SEEK_SET);
          item.data.resize(end - off);
          item.ok = fread(item.data.data(), 1, item.data.size(), f) ==
                    item.data.size();
        }
        fclose(f);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        done.push_back(std::move(item));
      }
      cv_done.notify_one();
    }
  }
};

}  // namespace

extern "C" {

int64_t dawn_npy_read(const char* path, uint8_t* out, int64_t cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t off = npy_payload_offset(f);
  if (off < 0) { fclose(f); return -1; }
  fseek(f, 0, SEEK_END);
  long end = ftell(f);
  int64_t n = end - off;
  if (n > cap) { fclose(f); return -2; }
  fseek(f, off, SEEK_SET);
  int64_t got = (int64_t)fread(out, 1, n, f);
  fclose(f);
  return got == n ? n : -1;
}

void* dawn_prefetch_create(int32_t n_threads, int32_t queue_cap) {
  return new Prefetcher(n_threads, static_cast<size_t>(queue_cap));
}

void dawn_prefetch_submit(void* h, const char* path, int64_t tag) {
  auto* p = static_cast<Prefetcher*>(h);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->pending.emplace_back(path, tag);
  }
  p->cv_pending.notify_one();
}

int64_t dawn_prefetch_next(void* h, uint8_t* out, int64_t cap, int64_t* tag) {
  auto* p = static_cast<Prefetcher*>(h);
  Item item;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_done.wait(lk, [&] { return !p->done.empty(); });
    item = std::move(p->done.front());
    p->done.pop_front();
  }
  p->cv_pending.notify_all();  // queue slot freed
  *tag = item.tag;
  if (!item.ok) return -1;
  if (static_cast<int64_t>(item.data.size()) > cap) return -2;
  memcpy(out, item.data.data(), item.data.size());
  return static_cast<int64_t>(item.data.size());
}

void dawn_prefetch_destroy(void* h) {
  auto* p = static_cast<Prefetcher*>(h);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
  }
  p->cv_pending.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
