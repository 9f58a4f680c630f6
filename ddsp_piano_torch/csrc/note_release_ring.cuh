// The ring of TMA tiles that streams NoteRelease's (T, B) inputs through
// shared memory: the plan, the mbarrier and TMA helpers, the producer, the
// forward walk, and the host side (tensor-map encode and launch). Included
// by note_release.cu (K3) and note_release_bwd.cu (K6, K7).
//
// A block owns a slice of kLanes lanes (one consumer thread a lane, one
// consumer warp) and walks all T steps: forward for K3 and K6, reverse for
// K7; several blocks share B. Its input streams pass through a ring of
// kStages stages in shared memory, each a (kTile, kLanes) tile of every
// stream. Tiles are cut from t = 0, so the ragged tile is the last one a
// forward walk reaches and the first one K7 reaches. A producer thread
// fills a stage with one TMA box (cp.async.bulk.tensor.2d) a stream,
// kLanes lanes by kTile steps, completing on the stage's `full` mbarrier
// with the stage's byte count; the box past T or B is zero filled. TMA
// needs rows on 16 bytes, so B % 4 == 0: the wrapper pads the lanes of any
// other B with zeros. The consumer waits on `full`, walks the tile's steps
// with operands from shared memory and the carry in registers, stores its
// outputs straight to device memory (coalesced across the lanes; stores
// do not stall the chain) and arrives on the stage's `empty` mbarrier, so
// the producer refills it with the tile kStages ahead. kLanes, kTile and
// kStages are the plan a probe on the H100 chose (PERF.md);
// kernels/note_release.py note_release_plan states it and the launch
// checks it.

#pragma once

#include <cuda.h>           // CUtensorMap; the encoder is fetched at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;           // lanes a block: one consumer warp
constexpr int kThreads = 64;         // and one producer warp
constexpr int kTile = 64;            // steps a tile
constexpr int kStages = 2;           // tiles in the ring
constexpr int kRingOffset = 128;     // bytes of mbarriers before the tiles
constexpr int kSmemLimit = 232448;   // a block's shared memory on sm_90

__device__ __forceinline__ float sat_relu(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// One (kTile, kLanes) box of a (T, B) stream at (lane c0, step c1) by TMA;
// rows past T and lanes past B are filled with zeros and counted in the
// bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The ring's geometry, shared by the producer and the consumer.
struct Ring {
  float* tiles;        // kStages stages of NS tiles of (kTile, kLanes)
  uint32_t full;       // address of full[0]; full[s] at full + 8 s
  uint32_t empty;      // address of empty[0]
  int n_tiles, T;
  bool reverse;        // K7 walks the tiles from the end

  // The tile walked i-th: its first step, its rows and its stage.
  __device__ __forceinline__ void tile(int i, int* t0, int* rows,
                                       int* stage) const {
    const int k = reverse ? n_tiles - 1 - i : i;
    *t0 = k * kTile;
    *rows = min(kTile, T - *t0);
    *stage = i % kStages;
  }
};

// Barriers: full[s] completes when stage s holds its tile (the producer's
// one arrival with the byte count, and the bytes); empty[s] when the
// kLanes consumer threads have read it.
__device__ __forceinline__ Ring make_ring(int T, bool reverse) {
  extern __shared__ __align__(128) unsigned char smem[];
  Ring ring;
  ring.tiles = reinterpret_cast<float*>(smem + kRingOffset);
  ring.full = smem_addr(smem);
  ring.empty = ring.full + 8 * kStages;
  ring.n_tiles = (T + kTile - 1) / kTile;
  ring.T = T;
  ring.reverse = reverse;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(ring.full + 8 * s, 1);
      mbar_init(ring.empty + 8 * s, kLanes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return ring;
}

// A kernel's input streams, each (T, B) float32, as TMA descriptors of a
// (kTile, kLanes) box.
template <int NS>
struct Streams {
  CUtensorMap map[NS];
};

// The producer (the producer warp's first thread): for each tile in walk
// order, wait until its stage is released (from the second round on) and
// copy one box of every stream, with the stage's full byte count.
template <int NS>
__device__ __forceinline__ void produce(const Ring& ring,
                                        const Streams<NS>& in, int b0) {
  if (threadIdx.x != kLanes) return;
  for (int i = 0; i < ring.n_tiles; ++i) {
    int t0, rows, stage;
    ring.tile(i, &t0, &rows, &stage);
    const int round = i / kStages;
    if (round > 0) mbar_wait(ring.empty + 8 * stage, (round - 1) & 1);
    const uint32_t full = ring.full + 8 * stage;
    float* dst = ring.tiles + stage * NS * kTile * kLanes;
    mbar_expect_tx(full, NS * kTile * kLanes * 4);
    for (int k = 0; k < NS; ++k) {
      tma_load(smem_addr(dst + k * kTile * kLanes), &in.map[k], b0, t0,
               full);
    }
  }
}

// The forward recurrence of K3 (kSteps false) and K6 (kSteps true, which
// also stores the pre-update `steps`), the consumer warp's part: per lane
// b and step t, with the state (held note, steps),
//   activity    = min(max(note, 0), 1)
//   release_end = min(max(steps - threshold, 0), 1)
//   out         = activity * note + (1 - activity) * prev * (1 - release_end)
//   steps'      = (steps + 1) * (1 - activity) * (1 - release_end)
// then the final state. Built with --fmad=false, every multiply and add
// rounds on its own in this order, the order of the plain PyTorch version
// (kernels/note_release.py note_release_scan_plain_res).
template <bool kSteps>
__device__ __forceinline__ void forward_walk(
    const Ring& ring, const float* __restrict__ threshold,
    const float* __restrict__ state0, float* __restrict__ out,
    float* __restrict__ state_out, float* __restrict__ steps_out, int B,
    int b0) {
  const int j = threadIdx.x;
  const bool active = b0 + j < B;
  const int b = b0 + j;
  const float thr = threshold[0];
  float prev = active ? state0[2 * b] : 0.0f;
  float steps = active ? state0[2 * b + 1] : 0.0f;
  auto step = [&](const float* tile, int r, int t) {
    const size_t i = (size_t)t * B + b;
    const float note = tile[r * kLanes];
    if (kSteps) steps_out[i] = steps;
    const float activity = sat_relu(note);
    const float release_end = sat_relu(steps - thr);
    const float o = activity * note
                    + (1.0f - activity) * prev * (1.0f - release_end);
    steps = (steps + 1.0f) * (1.0f - activity) * (1.0f - release_end);
    prev = o;
    out[i] = o;
  };
  for (int i = 0; i < ring.n_tiles; ++i) {
    int t0, rows, stage;
    ring.tile(i, &t0, &rows, &stage);
    mbar_wait(ring.full + 8 * stage, (i / kStages) & 1);
    const float* tile = ring.tiles + stage * kTile * kLanes + j;
    if (active) {
      if (rows == kTile) {
#pragma unroll 8
        for (int r = 0; r < kTile; ++r) step(tile, r, t0 + r);
      } else {
        for (int r = 0; r < rows; ++r) step(tile, r, t0 + r);
      }
    }
    mbar_arrive(ring.empty + 8 * stage);
  }
  if (active) {
    state_out[2 * b] = prev;
    state_out[2 * b + 1] = steps;
  }
}

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up once through the runtime
// (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess
        && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// Fill the streams' TMA descriptors: (T, B) float32 arrays with rows 4 B
// bytes apart (B % 4 == 0, 16-byte aligned bases), read as boxes of
// (kTile, kLanes).
template <int NS>
int encode(Streams<NS>* in, const float* const* ptr, int T, int B) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)B, (cuuint64_t)T};
  const cuuint64_t strides[1] = {(cuuint64_t)B * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kLanes, (cuuint32_t)kTile};
  const cuuint32_t unit[2] = {1, 1};
  for (int k = 0; k < NS; ++k) {
    if (fn(&in->map[k], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
           const_cast<float*>(ptr[k]), dims, strides, box, unit,
           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
           CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return (int)cudaErrorInvalidValue;
    }
  }
  return 0;
}

// Check the caller's plan against this header's, fill the descriptors, set
// the kernel's shared-memory size and launch.
template <int NS>
int launch(const void* fn, Streams<NS>* in, const float* const* ptr,
           void** args, int T, int B, int lanes, int tile_t, int stages,
           int smem, cudaStream_t stream) {
  const int want = kRingOffset + kStages * NS * kTile * kLanes * 4;
  if (B <= 0 || B % 4 != 0 || T < 0 || lanes != kLanes || tile_t != kTile
      || stages != kStages || smem != want || smem > kSmemLimit) {
    return (int)cudaErrorInvalidValue;
  }
  for (int k = 0; k < NS; ++k) {
    if (reinterpret_cast<uintptr_t>(ptr[k]) % 16 != 0) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (T > 0) {
    const int err = encode(in, ptr, T, B);
    if (err != 0) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel(fn, dim3((B + kLanes - 1) / kLanes), dim3(kThreads),
                         args, smem, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace
