// Capped BFS distance fields as a bit-parallel frontier BFS, one warp per
// field. One kernel behind three launchers:
//
//   flood_sweep_launch    replaces `_sweep_kernel` with its int32 carry
//                         (`flood_fields_pallas(variant="sweep")`,
//                         active_tracking_rl_tpu/ops/flood_pallas.py:84, call
//                         :273), the main path's flood;
//   flood_sweep16_launch  replaces the same kernel with its int16 carry
//                         (`variant="sweep16"`, the same lines); the carry
//                         only halves the TPU kernel's VMEM traffic, and a
//                         bitset BFS that stages bytes has no carry to
//                         narrow, so this launcher is flood_sweep_launch;
//   flood_relax_launch    replaces `_relax_kernel` with its seeding
//                         `_init_fields` (`variant="relax"`, the same file
//                         :41 and :210, call :294), `flood_backend="pallas"`.
//
// Contract: mazes (N, S, S) uint8 (nonzero = wall), goals (N, G, 2) int32
// (row, col); out (N, G, S, S) int16 holds the 4-connected BFS distance from
// the goal where it is <= cap, and INF = 16000 elsewhere and at walls. A goal
// off the grid or on a wall (a (-1, -1) pad) seeds nothing: its field is all
// INF. S <= kMaxSide = 128.
//
// The caps, and why each is exact.
// * flood_sweep and flood_sweep16: cap = iters. `_sweep_kernel` solves the
//   BFS by fast sweeping, with either carry, and then maps distances > iters
//   to INF; the port's plain twin `flood_fields_plain` (ops/flood.py), which
//   serves both variants, is that capped BFS.
// * flood_relax: cap = check_every * ceil(iters / check_every), 0 when
//   iters <= 0. `_relax_kernel` runs Jacobi sweeps in chunks of
//   check_every (16) while the sweep count is < iters and the last chunk
//   changed something. From a single seed, k Jacobi sweeps leave exactly
//   the BFS distances <= k and INF elsewhere (induction on k). So the kernel
//   stops either after K = check_every * ceil(iters / check_every) sweeps,
//   giving the BFS capped at K, or earlier at a fixpoint, which is the
//   whole BFS and equals the BFS capped at K. The launcher computes the cap
//   in one place, `relax_cap` below; ops/flood.py:relax_cap is the same
//   rule for the plain twin.
// `tests/test_torch_flood_bfs.py` holds a Python model of the level loop
// below (rows as Python ints) to both plain twins and to JAX's interpreted
// Pallas kernels under these caps.
//
// One gap to `_sweep_kernel`, with either carry, for iters >= 256 only.
// The TPU kernel stops after 128 rounds (`_MAX_ROUNDS`). A round carries a
// shortest path through one vertical and one horizontal run, so every
// distance <= 255 is exact after 128 rounds; a cell at a distance in
// [256, iters] can be left too large, or INF, but only when every shortest
// path to it is a unit staircase that needs more than 128 rounds. This
// kernel is the capped BFS that the variants' contract (and their twin)
// defines, and gives the exact distance there, under flood_sweep_launch and
// flood_sweep16_launch alike. No field of the shipped maps comes near 256
// (the deepest measured fields reach 150-ish; PERF.md).
//
// Design for the H100. The work is bit logic on a warp's registers: no
// matrix product and no tile stream, so wgmma and TMA have nothing to do.
// * One warp per field. Row r of the grid is W = ceil(S / 32) 32-bit words
//   (3 at S = 81, 82), column c at bit c % 32 of word c / 32. Lane l owns
//   the contiguous band of rows l * R .. l * R + R - 1 with R = W rows (S <=
//   32 W, so 32 lanes cover the grid: 28 lanes at S = 82). Per lane three
//   R x W register sets: `avail` (free and not yet reached), the frontier,
//   the next frontier. Bits beyond column S - 1 and rows beyond S - 1 are
//   never free, so they act as walls.
// * A level, warp-synchronous, with no block barrier:
//     next = (F << 1 | F >> 1 | F_up | F_down) & avail;  avail &= ~next;
//   horizontal neighbours are shifts with carries between a row's words;
//   vertical ones stay inside a lane but at a band's edge, which takes one
//   __shfl_up_sync / __shfl_down_sync per word. Each set bit of `next` gets
//   the level written into the field (a __ffs loop). The loop stops when
//   __any_sync finds `next` empty or at level == cap. The work is about
//   depth x 3 W R word operations and one write per reached cell, against
//   the Jacobi kernel's depth x S^2 cell updates (about 140x more at S = 82)
//   and the fast-sweep kernel's rounds of 4 x S dependent shared-memory
//   steps on one thread a line.
// * Shared memory, one slice a warp, used twice. First it holds the maze,
//   loaded with coalesced 16-byte loads, from which 32-lane ballots build
//   the row bitsets. Then it stages the field, one byte a cell (255:
//   unreached), so that a slice is S^2 + 32 bytes (6,768 B at S = 82) and 32
//   fields (warps, in 16 blocks of 2) are resident on an SM, twice as many
//   as an int16 staging allows. The BFS writes each reached cell's level
//   into it; the warp then copies it out once, widening 8 bytes into one
//   16-byte store of 8 int16 (255 -> INF) per lane. A field starts on a
//   2-byte boundary (S^2 * 2 = 13,122 B at S = 81, 13,448 B at 82), so the
//   staged field is shifted by the destination's offset modulo 16 bytes:
//   staging and destination then share their vector boundaries, and only a
//   head and a tail of fewer than 8 cells each go one by one. Levels from
//   255 on do not fit a byte: at level 255 the warp copies the staged
//   levels out and writes every later level straight to the output. No
//   field of the shipped maps gets there; the perfect mazes of
//   chip_smoke.py and tests/test_torch_cuda.py do.
// * Every register array is indexed by constants only (the loops over rows
//   and words unroll, and the goal's word is picked by selects), so ptxas
//   keeps them out of local memory: 64 registers, no stack at S = 81, 82.
//
// What bounds it. Device memory sees the mazes read and the int16 fields
// written once: 113.7 MB at 512 x 16 x 82^2, 0.0339 ms at 3.35 TB/s. The
// kernel is well above that: a level is a chain of shuffles, word logic, a
// vote and the bit loop, so an SM is bound by the instructions each level
// issues, times the depth of the field (about 115-150 levels on the
// shipped maps). PERF.md has the times.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (see ops/flood.py). No PyTorch
// headers: the launchers have a plain C interface and are loaded with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 16000;
constexpr int kMaxSide = 128;  // W = 4 words a row, R = 4 rows a lane
constexpr int kWarps = 2;      // fields (warps) a block
constexpr int kStaged = 255;   // levels below are staged as bytes; 255: unreached
constexpr unsigned kFull = 0xffffffffu;

// Bytes of one warp's slice of shared memory: the maze (S^2 bytes) with up
// to 30 bytes of 16-byte rounding, or the staged field (S^2 bytes) with up
// to 7 bytes of lead-in; whole 16-byte vectors.
__host__ __device__ constexpr int slice_bytes(int s) {
  return (s * s + 32 + 15) / 16 * 16;
}
// A block at the largest side needs no opt-in beyond 48 KB.
static_assert(kWarps * slice_bytes(kMaxSide) <= 48 * 1024, "shared memory");

// Two staged bytes (bytes 0 and 1, or 2 and 3, of x as picked by `sel`) as
// two int16 in one word, 255 as INF.
__device__ __forceinline__ uint32_t widen2(uint32_t x, uint32_t sel) {
  const uint32_t v = __byte_perm(x, 0, sel);
  const uint32_t unreached = __vcmpeq2(v, 0x00ff00ffu);
  return (v & ~unreached) | (((kInf << 16) | kInf) & unreached);
}

// The staged field out to dst: cells up to dst's 16-byte boundary one by
// one, then 8 cells (8 staged bytes, 16 output bytes) a lane at a time,
// then the tail. stage + head is 8-byte aligned (see the caller).
__device__ __forceinline__ void copy_out(const uint8_t* stage, int16_t* dst,
                                         int cells, int lead, int lane) {
  const int head = min(cells, (8 - lead) % 8);
  if (lane < head) dst[lane] = stage[lane] == kStaged ? kInf : stage[lane];
  const int vecs = (cells - head) / 8;
  const uint2* src = reinterpret_cast<const uint2*>(stage + head);
  int4* out4 = reinterpret_cast<int4*>(dst + head);
  for (int i = lane; i < vecs; i += 32) {
    const uint2 b = src[i];
    out4[i] = make_int4(widen2(b.x, 0x4140), widen2(b.x, 0x4342),
                        widen2(b.y, 0x4140), widen2(b.y, 0x4342));
  }
  const int tail = head + vecs * 8;
  if (lane < cells - tail) {
    const uint8_t v = stage[tail + lane];
    dst[tail + lane] = v == kStaged ? kInf : v;
  }
}

template <int W>
__global__ void __launch_bounds__(32 * kWarps)
flood_bfs_kernel(const uint8_t* __restrict__ maze,
                 const int32_t* __restrict__ goals, int16_t* __restrict__ out,
                 int fields, int g, int s, int cap) {
  constexpr int R = W;  // rows a lane owns
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % 32;
  const int field = blockIdx.x * kWarps + threadIdx.x / 32;  // row * g + goal
  if (field >= fields) return;  // a whole warp leaves; no block barriers
  const int cells = s * s;
  uint8_t* slice = smem + (threadIdx.x / 32) * slice_bytes(s);

  // 1. The maze into the slice: the 16-byte chunks that cover it.
  const uint8_t* mz = maze + static_cast<size_t>(field / g) * cells;
  const uintptr_t first = reinterpret_cast<uintptr_t>(mz) & ~uintptr_t{15};
  const int off = static_cast<int>(reinterpret_cast<uintptr_t>(mz) - first);
  // A chunk that holds a byte of the maze lies inside the maze's allocation
  // (device allocations are aligned to far more than 16 bytes).
  const int4* chunks = reinterpret_cast<const int4*>(first);
  for (int i = lane; i < (off + cells + 15) / 16; i += 32)
    reinterpret_cast<int4*>(slice)[i] = __ldg(chunks + i);
  __syncwarp();

  // 2. Row bitsets: one ballot per (row, word); lane r / R keeps row r.
  const uint8_t* m = slice + off;
  uint32_t avail[R][W];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int w = 0; w < W; ++w) avail[j][w] = 0;
  for (int o = 0; o * R < s; ++o) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = o * R + j;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int c = w * 32 + lane;
        const uint32_t bits =
            __ballot_sync(kFull, r < s && c < s && m[r * s + c] == 0);
        avail[j][w] = lane == o ? bits : avail[j][w];
      }
    }
  }
  __syncwarp();

  // 3. The staged field, all unreached; cell i at stage[i], lead bytes
  // into the slice, so that stage[i] and dst[i] are i cells past a 16-byte
  // boundary of the output alike.
  int16_t* dst = out + static_cast<size_t>(field) * cells;
  const int lead = static_cast<int>((reinterpret_cast<uintptr_t>(dst) / 2) % 8);
  for (int i = lane; i < slice_bytes(s) / 16; i += 32)
    reinterpret_cast<int4*>(slice)[i] = make_int4(-1, -1, -1, -1);
  __syncwarp();
  uint8_t* stage = slice + lead;

  // 4. Seed: the goal, when it is on the grid and free, is level 0. Every
  // word is written with a select, never one picked by the goal's index:
  // an index known only at run time would put the arrays in local memory.
  const int gr = goals[2 * field];
  const int gc = goals[2 * field + 1];
  const bool mine = gr >= 0 && gr < s && gc >= 0 && gc < s && lane == gr / R;
  const uint32_t bit = mine ? 1u << (gc % 32) : 0u;
  uint32_t front[R][W];
  uint32_t seeded = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const uint32_t b = (j == gr % R && w == gc / 32) ? bit : 0u;
      front[j][w] = avail[j][w] & b;
      avail[j][w] &= ~b;
      seeded |= front[j][w];
    }
  }
  if (seeded) stage[gr * s + gc] = 0;

  // 5. Levels 1 .. cap, until a level reaches nothing. Levels from 255 on
  // (no shipped map's field is that deep) go straight to dst, after the
  // staged levels below 255 have been copied out.
  bool copied = false;
  for (int level = 1; level <= cap; ++level) {
    uint32_t up[W], down[W], next[R][W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      up[w] = __shfl_up_sync(kFull, front[R - 1][w], 1);      // row above
      down[w] = __shfl_down_sync(kFull, front[0][w], 1);      // row below
      if (lane == 0) up[w] = 0;
      if (lane == 31) down[w] = 0;
    }
    uint32_t any = 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const uint32_t f = front[j][w];
        uint32_t nb = (j > 0 ? front[j - 1][w] : up[w]) |
                      (j < R - 1 ? front[j + 1][w] : down[w]) |
                      (f << 1) | (f >> 1);
        if (w > 0) nb |= front[j][w - 1] >> 31;
        if (w < W - 1) nb |= front[j][w + 1] << 31;
        next[j][w] = nb & avail[j][w];
        any |= next[j][w];
      }
    }
    if (!__any_sync(kFull, any != 0)) break;
    if (level == kStaged) {  // warp-uniform
      __syncwarp();
      copy_out(stage, dst, cells, lead, lane);
      __syncwarp();
      copied = true;
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int row = (lane * R + j) * s;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        avail[j][w] &= ~next[j][w];
        front[j][w] = next[j][w];
        for (uint32_t bits = next[j][w]; bits; bits &= bits - 1) {
          const int i = row + w * 32 + __ffs(bits) - 1;
          if (level < kStaged)
            stage[i] = static_cast<uint8_t>(level);
          else
            dst[i] = static_cast<int16_t>(level);
        }
      }
    }
  }
  __syncwarp();

  // 6. Out, unless step 5 has done it.
  if (!copied) copy_out(stage, dst, cells, lead, lane);
}

template <int W>
int launch_w(const void* maze, const void* goals, void* out, int fields, int g,
             int s, int cap, cudaStream_t stream) {
  const size_t shmem = static_cast<size_t>(kWarps) * slice_bytes(s);
  // as much of the SM's memory as shared memory as it can have: 16 blocks
  // (32 fields) at S = 82
  const cudaError_t err = cudaFuncSetAttribute(
      flood_bfs_kernel<W>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (fields + kWarps - 1) / kWarps;
  flood_bfs_kernel<W><<<blocks, 32 * kWarps, shmem, stream>>>(
      static_cast<const uint8_t*>(maze), static_cast<const int32_t*>(goals),
      static_cast<int16_t*>(out), fields, g, s, cap);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* maze, const void* goals, void* out, int n, int g, int s,
           int cap, void* stream_ptr) {
  if (s < 1 || s > kMaxSide || n < 0 || g < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int fields = n * g;
  if (fields == 0) return 0;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch ((s + 31) / 32) {
    case 1: return launch_w<1>(maze, goals, out, fields, g, s, cap, stream);
    case 2: return launch_w<2>(maze, goals, out, fields, g, s, cap, stream);
    case 3: return launch_w<3>(maze, goals, out, fields, g, s, cap, stream);
    default: return launch_w<4>(maze, goals, out, fields, g, s, cap, stream);
  }
}

// `_relax_kernel`'s sweep count, the cap of its fields (see the note above):
// whole chunks of check_every sweeps while fewer than iters have run.
long long relax_cap(int iters, int check_every) {
  if (iters <= 0) return 0;
  return static_cast<long long>(check_every) *
         ((static_cast<long long>(iters) + check_every - 1) / check_every);
}

}  // namespace

// Each launches ceil(N * G / 2) blocks of 2 warps on `stream` and returns
// cudaGetLastError() (0 = ok), or cudaErrorInvalidValue for S outside
// [1, 128]. Every flood launcher of the port has one signature:
// (maze, goals, out, n, g, s, iters, extra, stream). Only the relax
// launcher reads `extra` (its check cadence); the two sweep launchers take
// it to keep that one signature and do not read it.

// Variant "sweep": cap = iters.
extern "C" int flood_sweep_launch(const void* maze, const void* goals, void* out,
                                  int n, int g, int s, int iters, int unused,
                                  void* stream) {
  (void)unused;
  return launch(maze, goals, out, n, g, s, iters, stream);
}

// Variant "sweep16": the same launch as "sweep", cap = iters.
extern "C" int flood_sweep16_launch(const void* maze, const void* goals,
                                    void* out, int n, int g, int s, int iters,
                                    int unused, void* stream) {
  (void)unused;
  return launch(maze, goals, out, n, g, s, iters, stream);
}

// Variant "relax": cap = relax_cap(iters, check_every), 16 in the TPU kernel.
extern "C" int flood_relax_launch(const void* maze, const void* goals, void* out,
                                  int n, int g, int s, int iters,
                                  int check_every, void* stream) {
  if (check_every < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long cap = relax_cap(iters, check_every);
  // a field is at most S^2 - 1 levels deep, so a larger cap changes nothing
  const int cap_int = cap > kMaxSide * kMaxSide ? kMaxSide * kMaxSide
                                                : static_cast<int>(cap);
  return launch(maze, goals, out, n, g, s, cap_int, stream);
}
