// The shared-memory ring that passes a chunk's right boundary column to
// the warp that sweeps the next chunk, for the multi-warp wavefronts of
// csrc/wavefront.cu (hard-min, K1/K3/K4 and bf16-K1; soft-min, K5/K6) and
// csrc/family_wavefront.cu (K7, both builds).
//
// Each link (warp p to warp (p+1) mod P) has its own ring of slots; a slot
// holds a group of 32 rows, and has a full and an empty mbarrier (arrival
// count 1).  The producer's lane 31 arrives on full after storing a
// group's rows, the consumer's lane 0 arrives on empty after its last read
// of the group, and the whole warp waits with try_wait.parity.  RingWalk
// is the schedule every multi-warp kernel walks (csrc/wavefront.cu
// explains it and its rules; tests/test_torch_wavefront_design.py models
// it); each kernel keeps only its own step and cell.

#pragma once

#include <stdint.h>

namespace {

constexpr int kGroup = 32;        // ring rows per full/empty pair

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// release: the arriving thread's earlier shared-memory accesses are
// visible to a thread whose wait sees the phase complete
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// acquire: true once the phase of the given parity has completed
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One link's ring: slot s holds a group of kGroup rows (f32, and i32 with
// the start lane); bars[2s] is its full, bars[2s+1] its empty mbarrier.
struct Ring {
  float* v;
  int* s;
  uint64_t* bars;
};

// A position in a link's stream of groups, which fill the slots in turn:
// the slot, and the parity of its use (flips each time round the ring).
// A warp keeps four: the next group it waits for (full) and releases
// (empty) on its input link, and the next it waits to fill (empty) and
// publishes (full) on its output link.  Each advances once per group, in
// stream order, across the warp's chunks.
struct Cursor {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance(int slots) {
    if (++slot == slots) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

// The ring slots one step reads and writes: lane 0 reads row t+1 at
// index u of rd (srd: its start lane) and lane 31 writes row t-31 at
// index u of wr (swr); reads / writes: this lane is lane 0 of a chunk
// with a left neighbour / lane 31 of a chunk with a right neighbour.
struct RingIO {
  const float* rd;
  const int* srd;
  float* wr;
  int* swr;
  bool reads, writes;
};

// One warp's walk of its two links (it reads ring `in`, written by the
// previous warp, and writes ring `out`) across the chunks it sweeps.
// The steps of a chunk run in blocks of 32, block g holding steps
// t = 32g - 1 + u (u < 32): lane 0 reads row t+1 = 32g + u (consumer
// group g) and lane 31 writes row t-31 = 32(g-1) + u (producer group
// g-1).  Block 0 starts at u = 1 (t = 0).  Per chunk: open_chunk, then
// (after the chunk's own loads) first_group, then open_block(g) before
// every block g > 0, then close_chunk.  START: the rings carry the start
// lane beside the value.
template <bool START>
struct RingWalk {
  Ring in, out;
  int slots;
  int groups;                       // ring groups per chunk, ceil(m / 32)
  int lane;
  bool has_in = false, has_out = false;
  Cursor in_wait, in_release, out_wait, out_publish;

  // chunk c of `chunks`: the last one writes no ring and chunk 0 reads
  // none (a warp with no chunk never gets here: it touches no mbarrier)
  __device__ __forceinline__ void open_chunk(int c, int chunks, RingIO& io) {
    has_in = c > 0;
    has_out = c + 1 < chunks;
    io.reads = has_in && lane == 0;
    io.writes = has_out && lane == 31;
  }

  // waits for the chunk's first consumer group; true if it has one
  __device__ __forceinline__ bool first_group(RingIO& io) {
    if (has_in) {
      take_in(io);
      __syncwarp();
    }
    return has_in;
  }

  // A block first releases what the previous one read and stored (the
  // arrivals), then waits for its groups.
  __device__ __forceinline__ void open_block(int g, RingIO& io) {
    if (has_in) {
      if (lane == 0) mbar_arrive(in.bars + 2 * in_release.slot + 1);
      in_release.advance(slots);
    }
    if (has_out && g >= 2) publish();
    if (has_in && g < groups) take_in(io);
    if (has_out && g - 1 < groups) take_out(io);
    __syncwarp();
  }

  // the last group's rows are stored after the last block
  __device__ __forceinline__ void close_chunk() {
    if (has_out) publish();
    __syncwarp();
  }

  // consumer: wait for the next group's rows
  __device__ __forceinline__ void take_in(RingIO& io) {
    mbar_wait(in.bars + 2 * in_wait.slot, in_wait.phase);
    io.rd = in.v + in_wait.slot * kGroup;
    if (START) io.srd = in.s + in_wait.slot * kGroup;
    in_wait.advance(slots);
  }

  // producer: wait until the next group's slot was read in its previous
  // use (passes at once for its first use)
  __device__ __forceinline__ void take_out(RingIO& io) {
    mbar_wait(out.bars + 2 * out_wait.slot + 1, out_wait.phase ^ 1u);
    io.wr = out.v + out_wait.slot * kGroup;
    if (START) io.swr = out.s + out_wait.slot * kGroup;
    out_wait.advance(slots);
  }

  // lane 31 stored the group's rows
  __device__ __forceinline__ void publish() {
    if (lane == 31) mbar_arrive(out.bars + 2 * out_publish.slot);
    out_publish.advance(slots);
  }
};

}  // namespace
