// Asynchronous field-dump writer.
//
// Native runtime component: high-frequency field snapshots (flow
// visualization dumps, checkpoint streams) must not block the device step
// loop on host filesystem latency. A worker thread drains a queue of
// buffered write jobs; submission memcpy's the (host) array once and
// returns immediately.
//
// The reference's counterpart is collective parallel-HDF5 inside the MPI
// step loop (/root/reference/sopht_mpi/utils/mpi_io.py:291) - synchronous
// by construction. Exposed to Python through ctypes (utils/native_io.py);
// files are written in .npy format (header supplied by the Python side) so
// numpy/ParaView tooling can read them directly.
//
// Build: g++ -O2 -shared -fPIC -pthread -o libasyncdump.so async_dump.cpp

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

struct Job {
  std::string path;
  std::vector<uint8_t> header;
  std::vector<uint8_t> data;
};

struct Writer {
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<Job> queue;
  bool stopping = false;
  uint64_t submitted = 0;
  uint64_t completed = 0;
  uint64_t failed = 0;

  void run() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv.wait(lock, [&] { return stopping || !queue.empty(); });
        if (queue.empty()) {
          if (stopping) return;
          continue;
        }
        job = std::move(queue.front());
        queue.pop_front();
      }
      bool ok = false;
      FILE* f = std::fopen(job.path.c_str(), "wb");
      if (f != nullptr) {
        size_t nh = job.header.size();
        size_t nd = job.data.size();
        ok = (std::fwrite(job.header.data(), 1, nh, f) == nh) &&
             (std::fwrite(job.data.data(), 1, nd, f) == nd);
        std::fclose(f);
      }
      {
        std::lock_guard<std::mutex> lock(mu);
        completed += 1;
        if (!ok) failed += 1;
        cv.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

void* adw_create() {
  Writer* w = new Writer();
  w->worker = std::thread([w] { w->run(); });
  return w;
}

// Enqueue one file write (header + raw data are copied).
int adw_submit(void* handle, const char* path, const void* header,
               uint64_t header_bytes, const void* data, uint64_t data_bytes) {
  Writer* w = static_cast<Writer*>(handle);
  Job job;
  job.path = path;
  job.header.assign(static_cast<const uint8_t*>(header),
                    static_cast<const uint8_t*>(header) + header_bytes);
  job.data.assign(static_cast<const uint8_t*>(data),
                  static_cast<const uint8_t*>(data) + data_bytes);
  {
    std::lock_guard<std::mutex> lock(w->mu);
    w->queue.push_back(std::move(job));
    w->submitted += 1;
  }
  w->cv.notify_all();
  return 0;
}

// Number of jobs submitted but not yet written.
uint64_t adw_pending(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  std::lock_guard<std::mutex> lock(w->mu);
  return w->submitted - w->completed;
}

uint64_t adw_failed(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  std::lock_guard<std::mutex> lock(w->mu);
  return w->failed;
}

// Block until every submitted job has been written.
void adw_flush(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  std::unique_lock<std::mutex> lock(w->mu);
  w->cv.wait(lock, [&] { return w->completed == w->submitted; });
}

void adw_destroy(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  {
    std::lock_guard<std::mutex> lock(w->mu);
    w->stopping = true;
  }
  w->cv.notify_all();
  w->worker.join();
  delete w;
}

}  // extern "C"
