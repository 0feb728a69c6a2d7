// The voxel grid's sums of the preprocess (ops/preproc.py `voxel_sums`), bound to Python
// with ctypes.
//
// Replaces no Pallas kernel: the JAX package sums each voxel's points with a one-hot
// (max_points, max_raw_points) matrix product, which XLA fuses on the TPU.  Built as such a
// product on the card, the one-hot is max_points x max_raw_points floats written and read
// again: 128 MiB at (4,096 x 8,192), 1.26 GB at (8,192 x 38,528) for a 224x172 sensor.
// Here the work is linear in the cloud.
//
// Input: the cloud's voxel keys sorted ascending by a stable sort (ops/preproc.py
// `voxel_keys`: a valid point's key lies below `key_limit`, an invalid one's at or above
// it, so the invalid rows come last) and the points in that order.  A voxel is a run of
// equal keys.  Output: one row a voxel in key order, its centroid, up to n_out rows; the
// rows past the voxel count are 0 and invalid; the count, min(voxels, n_out); and the
// voxels past n_out added to a device counter (`dropped`).
//
// Two launches over tiles of 1,024 sorted points, one a thread:
//   * voxel_starts_kernel: each tile's count of run starts (a valid key unlike the one
//     before);
//   * voxel_sums_kernel: each block sums the counts of the tiles before its own (38 tiles
//     at 38,528 points), ranks its starts with a block scan, and the thread of each start
//     below n_out walks its run: the run's end first (its keys), then the sum
//     of its points from zero in sorted order, one round-to-nearest add at a time, and the
//     centroid as the sum over the count, one correctly rounded division.  That is PCL's
//     VoxelGrid order (a zero centroid, += each point of the run, /= the count) and the
//     order of the plain version, so the two are bit-equal in float32 and float64.
//     The blocks also zero the rows past the count.  Block 0 writes the count, adds the
//     dropped voxels and counts the launch (`ran`).
//
// What bounds it: latency.  The cloud is ~0.6 MB at 38,528 points, 0.2 us at 3.35 TB/s;
// the two launches and the longest run's serial walk (a voxel close to the sensor holds
// hundreds of points) take longer.  The sum's order is fixed, so a run is not split
// across threads.
//
// Each entry returns a CUDA error code (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;   // sorted points a block, one a thread
constexpr int kWarps = kTile / 32;

__device__ __forceinline__ bool run_start(const int* keys, int i, int n, int key_limit) {
  if (i >= n) return false;
  const int k = keys[i];
  return k < key_limit && (i == 0 || keys[i - 1] != k);
}

__global__ void __launch_bounds__(kTile)
    voxel_starts_kernel(const int* keys, int n, int key_limit, int* tile_starts) {
  const int i = blockIdx.x * kTile + threadIdx.x;
  const int c = __syncthreads_count(run_start(keys, i, n, key_limit));
  if (threadIdx.x == 0) tile_starts[blockIdx.x] = c;
}

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kTile)
    voxel_sums_kernel(const int* keys, const T* pts, int n, int key_limit,
                      const int* tile_starts, int n_tiles, int n_out, T* centroids,
                      bool* valid, int* count, long long* dropped, long long* ran) {
  __shared__ int warp_offset[kWarps];
  __shared__ int s_before, s_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp == 0) {
    // the voxels of the tiles before this one, and of the whole cloud
    int before = 0, total = 0;
    for (int t = lane; t < n_tiles; t += 32) {
      const int c = tile_starts[t];
      total += c;
      if (t < static_cast<int>(blockIdx.x)) before += c;
    }
    for (int o = 16; o > 0; o >>= 1) {
      before += __shfl_down_sync(0xffffffffu, before, o);
      total += __shfl_down_sync(0xffffffffu, total, o);
    }
    if (lane == 0) {
      s_before = before;
      s_total = total;
    }
  }
  const int i = blockIdx.x * kTile + tid;
  const bool start = run_start(keys, i, n, key_limit);
  const unsigned ballot = __ballot_sync(0xffffffffu, start);
  if (lane == 0) warp_offset[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {   // exclusive scan of the warps' counts (kWarps == 32)
    const int v = warp_offset[lane];
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    warp_offset[lane] = x - v;
  }
  __syncthreads();
  const int total = s_total;
  const int cnt = min(total, n_out);
  if (start) {
    const int g = s_before + warp_offset[warp] + __popc(ballot & ((1u << lane) - 1u));
    if (g < n_out) {
      const int key = keys[i];
      int end = i + 1;
      while (end < n && keys[end] == key) ++end;
      T sx = 0, sy = 0, sz = 0;
      for (int j = i; j < end; ++j) {
        sx = add_rn(sx, pts[3 * j]);
        sy = add_rn(sy, pts[3 * j + 1]);
        sz = add_rn(sz, pts[3 * j + 2]);
      }
      const T c = static_cast<T>(end - i);
      centroids[3 * g] = div_rn(sx, c);
      centroids[3 * g + 1] = div_rn(sy, c);
      centroids[3 * g + 2] = div_rn(sz, c);
      valid[g] = true;
    }
  }
  for (int r = blockIdx.x * kTile + tid; r < n_out; r += gridDim.x * kTile) {
    if (r >= cnt) {
      centroids[3 * r] = 0;
      centroids[3 * r + 1] = 0;
      centroids[3 * r + 2] = 0;
      valid[r] = false;
    }
  }
  if (blockIdx.x == 0 && tid == 0) {
    *count = cnt;
    if (total > n_out) *dropped += total - n_out;
    *ran += 1;
  }
}

template <typename T>
int launch(const void* keys, const void* pts, int n, int key_limit, int n_out,
           void* tile_starts, void* centroids, void* valid, void* count, void* dropped,
           void* ran, cudaStream_t stream) {
  const int tiles = n > 0 ? (n + kTile - 1) / kTile : 1;
  const int* k = static_cast<const int*>(keys);
  int* starts = static_cast<int*>(tile_starts);
  voxel_starts_kernel<<<tiles, kTile, 0, stream>>>(k, n, key_limit, starts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  voxel_sums_kernel<T><<<tiles, kTile, 0, stream>>>(
      k, static_cast<const T*>(pts), n, key_limit, starts, tiles, n_out,
      static_cast<T*>(centroids), static_cast<bool*>(valid), static_cast<int*>(count),
      static_cast<long long*>(dropped), static_cast<long long*>(ran));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// is64: the points and centroids are float64 (else float32).  keys: n int32, sorted;
// pts: n x 3 in the keys' order; tile_starts: ceil(n / 1,024) int32 of scratch;
// centroids: n_out x 3; valid: n_out bools; count: one int32; dropped, ran: one int64 each,
// added to.
extern "C" int pcs_voxel_sums(int is64, const void* keys, const void* pts, int n,
                              int key_limit, int n_out, void* tile_starts, void* centroids,
                              void* valid, void* count, void* dropped, void* ran,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is64)
    return launch<double>(keys, pts, n, key_limit, n_out, tile_starts, centroids, valid,
                          count, dropped, ran, s);
  return launch<float>(keys, pts, n, key_limit, n_out, tile_starts, centroids, valid, count,
                       dropped, ran, s);
}
