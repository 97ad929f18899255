// BFS distance fields by synchronous min-plus relaxation, one field per block.
//
// Replaces the TPU kernel `_relax_kernel` with its seeding `_init_fields`,
// reached through `flood_fields_pallas(variant="relax")`
// (`flood_backend="pallas"`) in active_tracking_rl_tpu/ops/flood_pallas.py.
// Contract: mazes (N, S, S) uint8 (nonzero = wall), goals (N, G, 2) int32
// (row, col); out (N, G, S, S) int16. A goal off the grid (a (-1, -1) pad)
// or on a wall seeds nothing, so its field is all INF = 16000; walls stay
// INF. Each sweep is one Jacobi step over the whole field,
//     d'[c] = wall[c] ? INF : min(d[c], min over the 4 neighbours of d + 1),
// with INF beyond the grid's edge. Sweeps run in chunks of `check_every`
// (16): after each chunk the block stops if the chunk changed nothing, or
// once the sweep count is >= iters. So for an `iters` that is not a multiple
// of 16 it runs up to ceil(iters / 16) * 16 sweeps, and distances a little
// beyond iters stay finite: that is the TPU kernel's behaviour, reproduced
// here. Unlike the fast-sweep kernel there is no cap applied afterwards.
//
// Design. The field is double-buffered in shared memory as int16 (values
// never exceed INF; the + 1 is done in int), with a ring of INF cells around
// the grid so no neighbour read needs a bounds test, and a wall mask whose
// ring is wall: (S + 2)^2 * 5 B = 35.3 KB at S = 82, under the 48 KB a block
// may use without opting in. A sweep reads buffer `a` and writes buffer `b`,
// then the two swap after a barrier, which is what makes it synchronous (an
// in-place Gauss-Seidel sweep would converge faster and give other fields
// where the iteration cap binds). Each thread ORs a "changed" flag over the
// chunk; `__syncthreads_or` decides the stop. The sweep is monotone, so that
// equals the TPU kernel's any(nd != d) over the chunk. A 32 x 8 thread block
// walks the grid in tiles, neighbouring threads on neighbouring cells.
//
// What bounds it on an H100. Device memory sees only the read of the maze
// and the write of the int16 fields: 110 MB at 512 rows x 16 goals x 82^2,
// 33 us at 3.35 TB/s. The work, though, is one 5-point min-plus update per
// cell per sweep, about as many sweeps as the farthest reachable cell is
// from the goal (up to 256 at the main path's cap), all in shared memory,
// so the kernel is bound by shared-memory traffic and the per-sweep barrier,
// far above the byte bound. PERF.md has the measured time.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (see ops/flood.py). No PyTorch
// headers: the launcher has a plain C interface and is loaded with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 16000;
constexpr int kTileX = 32;
constexpr int kTileY = 8;

__global__ void flood_relax_kernel(const uint8_t* __restrict__ maze,
                                   const int32_t* __restrict__ goals,
                                   int16_t* __restrict__ out, int g, int s,
                                   int iters, int check_every) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = s + 2;                     // padded side: an INF ring
  const int pcells = p * p;
  int16_t* a = reinterpret_cast<int16_t*>(smem);
  int16_t* b = a + pcells;
  uint8_t* wall = reinterpret_cast<uint8_t*>(b + pcells);

  const int field = blockIdx.x;  // row * g + goal index
  const uint8_t* m = maze + static_cast<size_t>(field / g) * s * s;
  const int gr = goals[2 * field];
  const int gc = goals[2 * field + 1];
  const bool goal_on_grid = gr >= 0 && gr < s && gc >= 0 && gc < s;
  const int goal_cell = (gr + 1) * p + (gc + 1);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  for (int i = tid; i < pcells; i += nthreads) {
    const int r = i / p - 1;
    const int c = i - (r + 1) * p - 1;
    const bool inside = r >= 0 && r < s && c >= 0 && c < s;
    const uint8_t w = inside ? (m[r * s + c] != 0) : 1;
    wall[i] = w;
    const int16_t v = (goal_on_grid && i == goal_cell && !w) ? 0 : kInf;
    a[i] = v;
    b[i] = v;  // keeps the ring at INF in both buffers
  }
  __syncthreads();

  for (int done = 0; done < iters; done += check_every) {
    int changed = 0;
    for (int k = 0; k < check_every; ++k) {
      for (int r = 1 + threadIdx.y; r <= s; r += kTileY) {
        for (int c = 1 + threadIdx.x; c <= s; c += kTileX) {
          const int i = r * p + c;
          const int cur = a[i];
          int best = min(min(static_cast<int>(a[i - p]), static_cast<int>(a[i + p])),
                         min(static_cast<int>(a[i - 1]), static_cast<int>(a[i + 1])));
          const int nv = wall[i] ? kInf : min(cur, best + 1);
          b[i] = static_cast<int16_t>(nv);
          changed |= nv != cur;
        }
      }
      __syncthreads();
      int16_t* tmp = a; a = b; b = tmp;
    }
    if (!__syncthreads_or(changed)) break;
  }

  int16_t* o = out + static_cast<size_t>(field) * s * s;
  for (int i = tid; i < s * s; i += nthreads) {
    const int r = i / s;
    const int c = i - r * s;
    o[i] = a[(r + 1) * p + (c + 1)];
  }
}

}  // namespace

// Launches N * G blocks of 32 x 8 threads on `stream`; returns
// cudaGetLastError() (0 = ok). `check_every` is the chunk of sweeps between
// convergence checks (16 in the TPU kernel).
extern "C" int flood_relax_launch(const void* maze, const void* goals, void* out,
                                  int n, int g, int s, int iters,
                                  int check_every, void* stream) {
  const int fields = n * g;
  if (fields == 0) return 0;
  if (check_every < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t pcells = static_cast<size_t>(s + 2) * (s + 2);
  const size_t shmem = pcells * (2 * sizeof(int16_t) + 1);
  flood_relax_kernel<<<fields, dim3(kTileX, kTileY), shmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(maze), static_cast<const int32_t*>(goals),
      static_cast<int16_t*>(out), g, s, iters, check_every);
  return static_cast<int>(cudaGetLastError());
}
