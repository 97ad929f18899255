// Exact 4-connected BFS distance fields by fast sweeping with an int16
// carry, one field per block.
//
// Replaces the TPU kernel `_sweep_kernel` reached through
// `flood_fields_pallas(variant="sweep16")` (its int16 carry) in
// active_tracking_rl_tpu/ops/flood_pallas.py:84 (call :273). The int32
// variant, `variant="sweep"`, runs on csrc/flood_bfs.cu instead. Contract
// (the same as the iteration-capped relaxation `distance_fields` in
// envs/distance.py of both packages): mazes (N, S, S) uint8 (nonzero =
// wall), goals (N, G, 2) int32 (row, col); out (N, G, S, S) int16 holds the
// BFS distance to the goal where it is <= cap, and INF = 16000 elsewhere, at
// walls, and for every cell of a field whose goal is off the grid or on a
// wall (a (-1, -1) pad row).
//
// Design. One thread block per field keeps the (S, S) field and the wall
// mask in shared memory for the whole solve, the field in int16 (3 B a
// cell with the mask: 20.2 KB at S = 82). Arithmetic is done in int and a
// value is stored only when it is prev + 1 < cur <= INF, so the int16 carry
// cannot overflow. A round is four Gauss-Seidel passes: down every column,
// up every column, right along every row, left along every row. Each pass
// gives one thread to one line and scans it in sequence, d = min(d, prev +
// 1) on free cells, so one pass carries a distance along a whole straight
// run. A shortest path with z turns is exact after about z / 2 + 1 rounds.
// The block stops after the first round that changes nothing (or after
// max_rounds), applies the cap and writes int16. The pass order is the TPU
// kernel's (axis 1 forward and back, then axis 2), so even a field stopped
// by max_rounds matches it.
//
// What bounds it on an H100. The least work is the output: N * G * S * S
// int16 values, 110 MB per pool refresh at 512 rows x 16 goals x 82^2, which
// is 33 us at 3.35 TB/s; the inputs (3.4 MB of mazes) are noise. The design
// writes each output byte once, with neighbouring threads on neighbouring
// addresses, and keeps every intermediate round in shared memory, so device
// memory sees only that one write and the one read of the maze. What it does
// not yet do is hide the serial scans: each pass is S dependent shared-memory
// steps on 82 of the block's 96 threads, so the kernel is latency-bound far
// above the byte bound (PERF.md has the measured time). Its redesign is to
// run this variant on csrc/flood_bfs.cu too (ROADMAP.md).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (see ops/flood.py). No PyTorch
// headers: the launcher has a plain C interface and is loaded with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 16000;

template <typename T>
__global__ void flood_sweep_kernel(const uint8_t* __restrict__ maze,
                                   const int32_t* __restrict__ goals,
                                   int16_t* __restrict__ out, int g, int s,
                                   int cap, int max_rounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* d = reinterpret_cast<T*>(smem);                  // (s, s) field
  uint8_t* wall = smem + sizeof(T) * s * s;           // (s, s) walls

  const int field = blockIdx.x;  // row * g + goal index
  const int cells = s * s;
  const uint8_t* m = maze + static_cast<size_t>(field / g) * cells;
  const int gr = goals[2 * field];
  const int gc = goals[2 * field + 1];
  const bool goal_on_grid = gr >= 0 && gr < s && gc >= 0 && gc < s;
  const int goal_cell = gr * s + gc;

  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const uint8_t w = m[i] != 0;
    wall[i] = w;
    d[i] = static_cast<T>((goal_on_grid && i == goal_cell && !w) ? 0 : kInf);
  }
  __syncthreads();

  const int t = threadIdx.x;
  for (int round = 0; round < max_rounds; ++round) {
    int changed = 0;
    if (t < s) {  // down column t
      int prev = d[t];
      for (int r = 1; r < s; ++r) {
        const int i = r * s + t;
        int cur = d[i];
        if (!wall[i] && prev + 1 < cur) { cur = prev + 1; d[i] = static_cast<T>(cur); changed = 1; }
        prev = cur;
      }
    }
    __syncthreads();
    if (t < s) {  // up column t
      int prev = d[(s - 1) * s + t];
      for (int r = s - 2; r >= 0; --r) {
        const int i = r * s + t;
        int cur = d[i];
        if (!wall[i] && prev + 1 < cur) { cur = prev + 1; d[i] = static_cast<T>(cur); changed = 1; }
        prev = cur;
      }
    }
    __syncthreads();
    if (t < s) {  // right along row t
      int prev = d[t * s];
      for (int c = 1; c < s; ++c) {
        const int i = t * s + c;
        int cur = d[i];
        if (!wall[i] && prev + 1 < cur) { cur = prev + 1; d[i] = static_cast<T>(cur); changed = 1; }
        prev = cur;
      }
    }
    __syncthreads();
    if (t < s) {  // left along row t
      int prev = d[t * s + s - 1];
      for (int c = s - 2; c >= 0; --c) {
        const int i = t * s + c;
        int cur = d[i];
        if (!wall[i] && prev + 1 < cur) { cur = prev + 1; d[i] = static_cast<T>(cur); changed = 1; }
        prev = cur;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }

  int16_t* o = out + static_cast<size_t>(field) * cells;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int v = d[i];
    o[i] = static_cast<int16_t>(v > cap ? kInf : v);
  }
}

template <typename T>
int launch(const void* maze, const void* goals, void* out, int n, int g, int s,
           int cap, int max_rounds, void* stream) {
  const int fields = n * g;
  if (fields == 0) return 0;
  const int threads = ((s + 31) / 32) * 32;
  const size_t shmem = static_cast<size_t>(s) * s * (sizeof(T) + 1);
  flood_sweep_kernel<T><<<fields, threads, shmem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(maze), static_cast<const int32_t*>(goals),
      static_cast<int16_t*>(out), g, s, cap, max_rounds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches N * G blocks on `stream` and returns cudaGetLastError() (0 = ok);
// the field is carried in int16 (variant "sweep16").
extern "C" int flood_sweep16_launch(const void* maze, const void* goals,
                                    void* out, int n, int g, int s, int cap,
                                    int max_rounds, void* stream) {
  return launch<int16_t>(maze, goals, out, n, g, s, cap, max_rounds, stream);
}
