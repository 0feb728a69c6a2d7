// Device stamps and tallies of the port's tracer (trace.py), bound to Python with ctypes.
//
// Replaces no TPU kernel: the JAX program is one XLA executable that nothing
// times from inside, and the port's frame is one CUDA graph whose inside a
// host clock cannot see.  A stamp is a one-thread kernel that reads the
// card's %globaltimer (ns) into one slot of a ring of rows on the card; the
// tracer captures one at each stage boundary of the frame (pipeline.py,
// ops/hough.py), so every replay writes the frame's row.  Bound by launch
// latency alone (a few stores): it does no work the frame needs, and a
// graph captured with tracing off holds none of them.
//
// The ring: `rows` is n_rows x width int64, `counter` one int64 on the card,
// both made before any capture.  Slot 0 (the frame's first stamp) bumps the
// counter, zeroes the row the counter selects, writes its tag (the frame's
// sequence number + 1) into the row's last slot and its time into slot 0;
// every later stamp writes its own slot of that row.  A stamp inside a
// conditional node whose flag is false never runs, so its slot reads 0.
// Stamps of one row run in stream order: one frame of a ring in flight.
//
// A tally is the same kind of kernel for a count: it adds one to its own
// slot of the row the counter selects (the frame's row, which slot 0
// zeroed), so a row carries the frame's counts beside its stamps.  Inside a
// conditional node it counts the replays whose flag held.
//
// Each entry returns a CUDA error code (0 on success).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__global__ void stamp_kernel(long long* rows, long long* counter, int n_rows, int width,
                             int slot) {
  const long long now = global_ns();
  long long seq;
  if (slot == 0) {
    seq = counter[0];
    counter[0] = seq + 1;
  } else {
    seq = counter[0] - 1;
  }
  long long* row = rows + (seq % n_rows) * width;
  if (slot == 0) {
    for (int i = 1; i < width - 1; ++i) row[i] = 0;
    row[width - 1] = seq + 1;
  }
  row[slot] = now;
}

__global__ void tally_kernel(long long* rows, const long long* counter, int n_rows,
                             int width, int slot) {
  const long long seq = counter[0] - 1;
  rows[(seq % n_rows) * width + slot] += 1;
}

__global__ void now_kernel(long long* out) { out[0] = global_ns(); }

}  // namespace

extern "C" int pcs_trace_stamp(void* rows, void* counter, int n_rows, int width, int slot,
                               void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(rows), static_cast<long long*>(counter), n_rows, width, slot);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pcs_trace_tally(void* rows, void* counter, int n_rows, int width, int slot,
                               void* stream) {
  tally_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(rows), static_cast<const long long*>(counter), n_rows, width,
      slot);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pcs_trace_now(void* out, void* stream) {
  now_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
