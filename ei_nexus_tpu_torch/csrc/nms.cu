// Kernel C: fixed-round iterative non-maximum suppression.
//
// Replaces: ei_nexus_tpu/ops/pallas_nms.py `_nms_kernel` (reached through
// `nms_pallas`), which keeps one whole (H, W) score map in VMEM for all
// rounds. Each of `n_iter` rounds (no early exit):
//   pooled = (2r+1)^2 window max, -inf outside the map
//   is_max = (x == pooled) & (x > 0)
//   x      = 0 where a max lies within r and x is not one, else x
// Only max, compare and select: the result is bit-identical to the plain
// version (ops/nms_kernel.py `nms_rounds_plain`).
//
// What bounds it on an H100: one read and one write of the maps, 5.95 MB
// for the flagship's (8, 264, 352) float32 call, ~1.8 us at 3.35 TB/s; the
// window arithmetic is a few tens of operations per pixel and round, all
// of it on chip.
//
// Design: the TPU's one-map-in-fast-memory design, on a thread-block
// cluster. A padded 264x352 float32 map (372 KB) is more than one SM's
// 227 KB, but a cluster of 8 blocks holds it in distributed shared memory,
// 33 whole rows a block. Each block loads its band once (16 bytes a load)
// and keeps it for every round; a row window needs only the block's own
// rows, and the r rows above and below that a column window needs are
// copied from the ranks that hold them (`map_shared_rank`) into the
// block's own halo rows, after a cluster barrier, not a grid-wide one.
// Clusters are independent: one per map, or per tile of a map that one
// cluster cannot hold (the plan, ops/nms_kernel.py `nms_plan`): the map is
// cut into row strips, and where its rows are too wide, column strips too.
// A tile loads 2*n_iter*r ghost rows and columns on each side where it was
// cut (a value after n rounds depends only on inputs that far away), runs
// every round on what it loaded, with the map-edge fill at its loaded
// edges, and writes only its own rows and columns, which are exact.
//
// The map stays as loaded: the zeros of the rounds so far are kept as
// bits, 32 pixels to a word (`sup`), applied wherever x is read and once
// more on the way out. One round:
//   1. row pass: each thread takes a run of pixels of one row into
//      registers and forms their (2r+1) window maxima by doubling, into
//      `rmax`; cluster barrier; the halo rows of `rmax` copied from the
//      peers;
//   2. column pass: the same down a column of `rmax`, compared with x; a
//      warp ballot packs is_max 32 pixels to a word (`ism`), one word a
//      row kept by the lane of that row;
//   3. the row dilation of the is_max words (shifts and ORs with the
//      neighbouring words), into `dil`; cluster barrier; the halo rows of
//      `dil` copied from the peers;
//   4. sup |= (2r+1 `dil` words down each column) & ~is_max.
// A peer reads a block's own rows of `rmax` only between the two barriers
// of a round and of `dil` only after the second, and the block writes them
// again only after the next barrier, so no buffer is overwritten while a
// peer may read it; a last cluster barrier keeps a block from leaving while
// a peer may still read it. Global traffic: one read and one write of each
// map (plus the ghost rows and columns of a tile), no scratch tensor.
#include <cooperative_groups.h>

#include "common.cuh"

namespace ei {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// Row pass: pixels a thread takes along a row (odd, so a warp's runs hit
// distinct banks); column pass: the most rows a thread takes down a column.
// Fewer above radius 4, to keep the windows in 64 registers.
template <int R> constexpr int kRun = R <= 4 ? 21 : 7;
template <int R> constexpr int kChunk = R <= 4 ? 17 : 8;
constexpr int kMaxRadius = 8;  // radii compiled: 1..kMaxRadius
constexpr int kCluster = 8;    // blocks a cluster: the portable maximum
constexpr int kMaxStrips = 128;
constexpr int kMaxDevices = 16;  // devices whose launch state is kept
constexpr int kErrNoCluster = -4;  // no cluster fits the card

// A map's tiles, from the plan: `n_rows` row strips, then `n_cols` column
// strips, each owning [x, y) and loading [z, w); tile (i, j) is row strip
// i by column strip j.
struct Tiles {
  int n_rows, n_cols;
  int4 s[kMaxStrips];
};

__host__ __device__ inline int nms_words(int W) { return (W + 31) / 32; }

// Dynamic shared memory of a block holding `rows` rows of width W at radius
// r: the map and its row pass (with r halo rows each side) in the storage
// type, rounded up to 16 bytes; then the zero and is_max words for its rows
// and the dilated words with r halo rows each side.
__host__ __device__ inline size_t nms_pixel_bytes(int rows, int W, int esize,
                                                  int radius) {
  return ((size_t)esize * W * (2 * rows + 2 * radius) + 15) / 16 * 16;
}
__host__ inline size_t nms_smem_bytes(int rows, int W, int esize,
                                      int radius) {
  return nms_pixel_bytes(rows, W, esize, radius) +
         sizeof(unsigned) * nms_words(W) * (3 * (size_t)rows + 2 * radius);
}

// The (2r+1) window maxima of values in registers, by doubling: after
// `pair_max<R, N>(v)`, the window of 2R + 1 values starting at v[i] has
// the maximum fmaxf(v[i], v[i + kTail<R>]) for each i < N (the maxima of
// two overlapping spans of 1 << kLevels<R> values).
template <int R> constexpr int kLevels = 2 * R + 1 >= 16 ? 4
                                       : 2 * R + 1 >= 8  ? 3
                                       : 2 * R + 1 >= 4  ? 2 : 1;
template <int R> constexpr int kTail = 2 * R + 1 - (1 << kLevels<R>);

template <int S, int R, int N>
__device__ __forceinline__ void pair_level(float (&v)[N + 2 * R]) {
#pragma unroll
  for (int i = 0; i + 2 * S - 1 < N + 2 * R; ++i)
    v[i] = fmaxf(v[i], v[i + S]);  // v[i]: the max of 2S values
}

template <int R, int N>
__device__ __forceinline__ void pair_max(float (&v)[N + 2 * R]) {
  pair_level<1, R, N>(v);
  if constexpr (kLevels<R> > 1) pair_level<2, R, N>(v);
  if constexpr (kLevels<R> > 2) pair_level<4, R, N>(v);
  if constexpr (kLevels<R> > 3) pair_level<8, R, N>(v);
}

// `buf` keeps R halo rows above and below a block's own rows, so row y of
// the cluster's L loaded rows is row y - k * rows + R of rank k's buffer.
// Copy into this block's halo rows (those above its nr rows from r0, and
// below) the rows that its peers hold; the rows outside the loaded ones
// keep their fill.
template <typename U>
__device__ __forceinline__ void pull_halo(cg::cluster_group& cluster, U* buf,
                                          int pitch, int R, int r0, int nr,
                                          int rows, int L) {
  for (int i = threadIdx.x; i < 2 * R * pitch; i += kThreads) {
    const int h = i / pitch, c = i - h * pitch;
    const int e = h < R ? h : nr + h, y = r0 - R + e;
    if (y >= 0 && y < L) {
      const int k = y / rows;
      buf[e * pitch + c] =
          *cluster.map_shared_rank(buf + (y - k * rows + R) * pitch + c, k);
    }
  }
}

// A cluster's tile: map b, its row strip and its column strip.
struct Tile {
  int b;
  int4 r, c;
};

// This block's tile: the grid is (column strips x kCluster, row strips,
// maps). The block index is read anew at each call, so that what is derived
// from it is not held in registers through the rounds (the write-out reads
// the tile again; held, it left the radius-3 and -4 float32 kernels a stack
// frame at 64 registers).
__device__ __forceinline__ Tile tile_of(const Tiles& tiles) {
  unsigned x, y, z;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(x));
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(y));
  asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(z));
  return {(int)z, tiles.s[y], tiles.s[tiles.n_rows + x / kCluster]};
}

// f(i, y, j) for each i = y * n + j < rows * n that this thread takes (i
// from threadIdx.x in steps of kThreads), y and j stepped along without a
// division in the loop.
template <typename F>
__device__ __forceinline__ void for_grid(int rows, int n, F f) {
  const int dy = kThreads / n, dj = kThreads - dy * n;
  int y = threadIdx.x / n, j = threadIdx.x - y * n;
  for (int i = threadIdx.x; i < rows * n; i += kThreads) {
    f(i, y, j);
    y += dy;
    j += dj;
    if (j >= n) {
      j -= n;
      ++y;
    }
  }
}

// Whether a tile's rows move 16 bytes at a time: the map's row pitch, the
// tile's column bounds and both pointers on 16-byte boundaries.
template <typename T>
__device__ __forceinline__ bool wide_rows(const T* in, const T* out,
                                          int pitch, int4 c) {
  constexpr int V = 16 / sizeof(T);
  return ((pitch | c.x | c.y | c.z | c.w) & (V - 1)) == 0 &&
         ((reinterpret_cast<size_t>(in) | reinterpret_cast<size_t>(out)) &
          15) == 0;
}

// in, out: (B, H, pitch) maps; each cluster runs one tile of one map.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 1)
    nms_kernel(const T* __restrict__ in, T* __restrict__ out, int H,
               int pitch, int rows, int n_iter,
               const __grid_constant__ Tiles tiles) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const Tile tile = tile_of(tiles);
  const int L = tile.r.w - tile.r.z;      // rows the cluster loaded
  const int W = tile.c.w - tile.c.z;      // columns it loaded
  const int r0 = rank * rows;             // this block's first loaded row
  const int nr = max(0, min(rows, L - r0));
  const int nw = nms_words(W);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ float4 smem4[];
  T* xs = reinterpret_cast<T*>(smem4);                 // rows x W
  T* rmax = xs + rows * W;                             // (rows + 2R) x W
  unsigned* sup = reinterpret_cast<unsigned*>(
      reinterpret_cast<char*>(smem4) +
      nms_pixel_bytes(rows, W, sizeof(T), R));         // rows x nw
  unsigned* ism = sup + rows * nw;                     // rows x nw
  unsigned* dil = ism + rows * nw;                     // (rows + 2R) x nw
  // x with the rounds' zeros so far
  auto x_at = [&](int y, int c) {
    return (sup[y * nw + (c >> 5)] >> (c & 31) & 1u) ? 0.f
                                                     : to_f(xs[y * W + c]);
  };

  // the band, 16 bytes a load where the rows and columns allow it
  constexpr int V = 16 / sizeof(T);
  const T* src =
      in + ((size_t)tile.b * H + tile.r.z + r0) * pitch + tile.c.z;
  if (wide_rows(in, out, pitch, tile.c)) {
    for_grid(nr, W / V, [&](int i, int y, int j) {
      reinterpret_cast<uint4*>(xs)[i] = reinterpret_cast<const uint4*>(
          src + (size_t)y * pitch)[j];
    });
  } else {
    for_grid(nr, W, [&](int i, int y, int j) {
      xs[i] = src[(size_t)y * pitch + j];
    });
  }
  for (int i = threadIdx.x; i < nr * nw; i += kThreads) sup[i] = 0u;
  // halo rows outside the loaded rows hold the fill for good; the others
  // are copied from the ranks that own them, every round
  for (int i = threadIdx.x; nr && i < 2 * R * W; i += kThreads) {
    const int h = i / W, e = h < R ? h : nr + h;
    if (r0 - R + e < 0 || r0 - R + e >= L)
      rmax[e * W + i - h * W] = from_f<T>(-INFINITY);
  }
  for (int i = threadIdx.x; nr && i < 2 * R * nw; i += kThreads) {
    const int h = i / nw, e = h < R ? h : nr + h;
    if (r0 - R + e < 0 || r0 - R + e >= L) dil[e * nw + i - h * nw] = 0u;
  }
  __syncthreads();

  constexpr int run = kRun<R>, chunk = kChunk<R>;
  const int runs = (W + run - 1) / run;
  const int chunks = (nr + chunk - 1) / chunk;
  const int q = chunks ? (nr + chunks - 1) / chunks : 0;
  for (int it = 0; it < n_iter; ++it) {
    // 1. window max along each row, -inf outside the map
    for (int g = threadIdx.x; g < nr * runs; g += kThreads) {
      const int y = g / runs, c0 = (g - y * runs) * run;
      // the zero bits of columns c0 - R ..: at most two words
      const int c1 = c0 - R, w1 = c1 >> 5;
      const unsigned* srow = sup + y * nw;
      const unsigned long long bits =
          ((unsigned long long)(w1 + 1 < nw ? srow[w1 + 1] : 0u) << 32 |
           (w1 >= 0 ? srow[w1] : 0u)) >> (c1 & 31);
      const T* row = xs + y * W;
      float v[run + 2 * R];
#pragma unroll
      for (int j = 0; j < run + 2 * R; ++j) {
        const int c = c1 + j;
        v[j] = (c < 0 || c >= W) ? -INFINITY
               : (bits >> j & 1u) ? 0.f : to_f(row[c]);
      }
      pair_max<R, run>(v);
      T* dst = rmax + (R + y) * W;
#pragma unroll
      for (int i = 0; i < run; ++i)
        if (c0 + i < W) dst[c0 + i] = from_f<T>(fmaxf(v[i], v[i + kTail<R>]));
    }
    cluster.sync();
    if (nr) pull_halo(cluster, rmax, W, R, r0, nr, rows, L);
    __syncthreads();
    // 2. window max down each column; is_max packed by a warp ballot
    for (int item = warp; item < chunks * nw; item += kWarps) {
      const int wd = item % nw, y0 = item / nw * q;
      const int c = wd * 32 + lane;
      const int n = min(q, nr - y0) + 2 * R;  // rows of rmax to read
      const T* col = rmax + y0 * W + min(c, W - 1);  // window of row y0
      float v[chunk + 2 * R];
#pragma unroll
      for (int j = 0; j < chunk + 2 * R; ++j)
        v[j] = j < n ? to_f(col[j * W]) : -INFINITY;
      pair_max<R, chunk>(v);
      unsigned mine = 0u;  // lane i: the is_max word of row y0 + i
#pragma unroll
      for (int i = 0; i < chunk; ++i) {
        if (i < q && y0 + i < nr) {  // uniform across the warp
          const float m = fmaxf(v[i], v[i + kTail<R>]);
          const float x = c < W ? x_at(y0 + i, c) : 0.f;
          const unsigned bits = __ballot_sync(~0u, x == m && x > 0.f);
          if (lane == i) mine = bits;
        }
      }
      if (lane < min(q, nr - y0)) ism[(y0 + lane) * nw + wd] = mine;
    }
    __syncthreads();
    // 3. is_max dilated along each row: bit k of word w is column 32w + k
    for (int i = threadIdx.x; i < nr * nw; i += kThreads) {
      const int wd = i % nw;
      const unsigned cur = ism[i];
      const unsigned prev = wd > 0 ? ism[i - 1] : 0u;
      const unsigned next = wd + 1 < nw ? ism[i + 1] : 0u;
      unsigned m = cur;
#pragma unroll
      for (int d = 1; d <= R; ++d)
        m |= (cur << d) | (prev >> (32 - d)) | (cur >> d) |
             (next << (32 - d));
      dil[R * nw + i] = m;
    }
    cluster.sync();
    if (nr) pull_halo(cluster, dil, nw, R, r0, nr, rows, L);
    __syncthreads();
    // 4. zero every non-max with a max within r: dilated down each column
    for (int i = threadIdx.x; i < nr * nw; i += kThreads) {
      unsigned near = 0u;
#pragma unroll
      for (int e = 0; e <= 2 * R; ++e) near |= dil[e * nw + i];
      sup[i] |= near & ~ism[i];
    }
    __syncthreads();
  }

  // this block's rows among the tile's own rows, and the tile's own
  // columns: [ox, ox + wo) of those it loaded
  const Tile own = tile_of(tiles);
  const int4 st = own.r, ct = own.c;
  const int lo = max(r0, st.x - st.z), hi = min(r0 + nr, st.y - st.z);
  const int ox = ct.x - ct.z, wo = ct.y - ct.x;
  T* dst = out + ((size_t)own.b * H + st.z + lo) * pitch + ct.x;
  if (wide_rows(in, out, pitch, ct)) {
    // V pixels a store, their zero bits in one word (V divides ox and 32)
    for_grid(hi - lo, wo / V, [&](int, int y, int j) {
      const int p = j * V, c = ox + p, ys = lo - r0 + y;
      const unsigned z = sup[ys * nw + (c >> 5)] >> (c & 31);
      uint4 val = *reinterpret_cast<const uint4*>(xs + ys * W + c);
      auto keep = [&](unsigned w, int j) {  // 32-bit word j of the pixels
        if (sizeof(T) == 4) return (z >> j & 1u) ? 0u : w;
        return w & ((z >> 2 * j & 1u) ? 0xffff0000u : ~0u) &
               ((z >> (2 * j + 1) & 1u) ? 0x0000ffffu : ~0u);
      };
      val = make_uint4(keep(val.x, 0), keep(val.y, 1), keep(val.z, 2),
                       keep(val.w, 3));
      *reinterpret_cast<uint4*>(dst + (size_t)y * pitch + p) = val;
    });
  } else {
    for_grid(hi - lo, wo, [&](int, int y, int p) {
      const int c = ox + p, ys = lo - r0 + y;
      dst[(size_t)y * pitch + p] = (sup[ys * nw + (c >> 5)] >> (c & 31) & 1u)
                                       ? from_f<T>(0.f) : xs[ys * W + c];
    });
  }
  cluster.sync();  // no block leaves while a peer may read its rows
}

template <typename T>
using NmsKernel = void (*)(const T*, T*, int, int, int, int, Tiles);

template <typename T>
static NmsKernel<T> kernel_for(int radius) {
  switch (radius) {
    case 1: return nms_kernel<T, 1>;
    case 2: return nms_kernel<T, 2>;
    case 3: return nms_kernel<T, 3>;
    case 4: return nms_kernel<T, 4>;
    case 5: return nms_kernel<T, 5>;
    case 6: return nms_kernel<T, 6>;
    case 7: return nms_kernel<T, 7>;
    case 8: return nms_kernel<T, 8>;
  }
  return nullptr;
}

// The launch configuration of a grid of blocks in clusters of kCluster.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(dim3 grid, size_t smem, cudaStream_t s) {
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

// Once per kernel and device: the shared-memory attribute, then the number
// of clusters that fit on the current device at once at the most shared
// memory a block may ask for. Returns that number (0: none), or a negative
// CUDA error. Devices past kMaxDevices are set up on every call.
template <typename T>
static int active_clusters(int radius) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  static int cache[kMaxDevices][kMaxRadius + 1];  // count + 1; 0: unset
  int* n = dev < kMaxDevices ? &cache[dev][radius] : nullptr;
  if (n && *n) return *n - 1;
  NmsKernel<T> kernel = kernel_for<T>(radius);
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return -(int)err;
  ClusterLaunch probe(dim3(kCluster), kMaxSmem, 0);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, (const void*)kernel,
                                       &probe.cfg);
  if (err != cudaSuccess) return -(int)err;
  if (n) *n = count + 1;
  return count;
}

// Whether strip (own0, own1, load0, load1) lies in [0, n) and owns rows.
static bool strip_ok(int4 s, int n) {
  return 0 <= s.z && s.z <= s.x && s.x < s.y && s.y <= s.w && s.w <= n;
}

template <typename T>
static int launch(const void* in, void* out, int B, int H, int W, int radius,
                  int n_iter, int rows, int n_rows, int n_cols,
                  const int* strips, cudaStream_t stream) {
  if (radius < 1 || radius > kMaxRadius || n_iter < 1 || rows < 1 ||
      n_rows < 1 || n_cols < 1 || n_rows + n_cols > kMaxStrips)
    return (int)cudaErrorInvalidValue;
  Tiles tiles;
  tiles.n_rows = n_rows;
  tiles.n_cols = n_cols;
  int width = 0;  // the most columns a tile loads
  for (int i = 0; i < n_rows + n_cols; ++i) {
    const int4 s = make_int4(strips[4 * i], strips[4 * i + 1],
                             strips[4 * i + 2], strips[4 * i + 3]);
    const bool is_row = i < n_rows;
    if (!strip_ok(s, is_row ? H : W) ||
        (is_row && s.w - s.z > kCluster * rows))
      return (int)cudaErrorInvalidValue;
    if (!is_row && s.w - s.z > width) width = s.w - s.z;
    tiles.s[i] = s;
  }
  const size_t smem = nms_smem_bytes(rows, width, sizeof(T), radius);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const int active = active_clusters<T>(radius);
  if (active < 0) return -active;
  if (active == 0) return kErrNoCluster;
  if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;  // grid z
  ClusterLaunch lc(dim3(n_cols * kCluster, n_rows, B), smem, stream);
  cudaError_t err = cudaLaunchKernelEx(
      &lc.cfg, kernel_for<T>(radius), static_cast<const T*>(in),
      static_cast<T*>(out), H, W, rows, n_iter, tiles);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace ei

// Shared memory one block of the plan needs (rows of `width` loaded
// columns, element size `esize`, radius r), for the caller to hold against
// its plan.
extern "C" long long ei_nms_smem_bytes(int rows, int width, int esize,
                                       int radius) {
  return (long long)ei::nms_smem_bytes(rows, width, esize, radius);
}

// Clusters of the radius-`radius` kernel that fit on the current device at
// once at the most shared memory a block may use; 0 if none, a negative
// CUDA error if the query failed.
extern "C" int ei_nms_active_clusters(int dtype, int radius) {
  if (radius < 1 || radius > ei::kMaxRadius)
    return -(int)cudaErrorInvalidValue;
  return dtype == ei::kBFloat16
             ? ei::active_clusters<__nv_bfloat16>(radius)
             : ei::active_clusters<float>(radius);
}

// score, out: (B, H, W) contiguous; strips: the plan's n_rows row strips
// then n_cols column strips, each (own0, own1, load0, load1); rows: rows a
// block holds. One launch of B * n_rows * n_cols clusters of 8 blocks, at
// most 65535 maps.
// Returns the CUDA error code of the launch (0 on success), or -4 if no
// cluster fits the card.
extern "C" int ei_nms_rounds(int dtype, const void* score, void* out, int B,
                             int H, int W, int radius, int n_iter, int rows,
                             int n_rows, int n_cols, const int* strips,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == ei::kFloat32)
    return ei::launch<float>(score, out, B, H, W, radius, n_iter, rows,
                             n_rows, n_cols, strips, s);
  if (dtype == ei::kBFloat16)
    return ei::launch<__nv_bfloat16>(score, out, B, H, W, radius, n_iter,
                                     rows, n_rows, n_cols, strips, s);
  return (int)cudaErrorInvalidValue;
}
