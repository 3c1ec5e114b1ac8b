// Phase probes of the fused K1 and K2 (their kProbe instances).
//
// A probed block reads the SM's cycle counter at the edges of its phases and
// adds its sums at exit, one atomicAdd a field, into a u64 accumulator that
// the wrapper passes (utils/trace.py:PROBE_FIELDS, the same order): nothing
// synchronises inside a pass. Thread 0, consumer warp 0's lane 0, adds every
// field but `form_wait`, which the first producer warp's lane 0 adds, and
// K1's two formation counts, which every producer warp's lane 0 adds (K2
// leaves them at 0). Each thread keeps its sums in 32-bit registers (a block
// lives far fewer than 2^32 cycles); every thread reads the clock, so that
// the reads add no branch in a warp that issues wgmma. The instance without
// kProbe reads no clock, counts nothing and compiles to the kernel as it
// was.
#pragma once

#include <cstdint>

namespace idg {

enum ProbeField {
  kProbeTotal,     // entry to exit
  kProbeK3,        // K3's region of the fused form
  kProbeLoop,      // the tile loop
  kProbeTcWait,    // consumer warp 0 at the tile loop's barriers, until released
  kProbeFormWait,  // the first producer warp at the same barriers
  kProbeBlocks,    // blocks
  kProbeFormTiles, // K1: tile formations of a producer warp
  kProbeFormFast,  // K1: those whose phasors all took the straight path (no fallback)
  kProbeFields
};

// the low 32 bits of clock64() in a probed instance, 0 (no read) otherwise
template <bool kProbe>
__device__ __forceinline__ uint32_t probe_clock() {
  if constexpr (kProbe) {
    return static_cast<uint32_t>(clock64());
  } else {
    return 0u;
  }
}

// __syncthreads(), its wait added to `waited` in a probed instance
template <bool kProbe>
__device__ __forceinline__ void probed_sync(uint32_t& waited) {
  const uint32_t t = probe_clock<kProbe>();
  __syncthreads();
  if constexpr (kProbe) waited += probe_clock<kProbe>() - t;
}

// a block's sums into the accumulator at its exit
__device__ __forceinline__ void probe_add(unsigned long long* probe, int tid, int first_producer,
                                          uint32_t total, uint32_t k3, uint32_t loop,
                                          uint32_t waited) {
  if (tid == 0) {
    atomicAdd(probe + kProbeTotal, (unsigned long long)total);
    atomicAdd(probe + kProbeK3, (unsigned long long)k3);
    atomicAdd(probe + kProbeLoop, (unsigned long long)loop);
    atomicAdd(probe + kProbeTcWait, (unsigned long long)waited);
    atomicAdd(probe + kProbeBlocks, 1ull);
  } else if (tid == first_producer) {
    atomicAdd(probe + kProbeFormWait, (unsigned long long)waited);
  }
}

// a producer warp's formation counts into the accumulator at its exit, by
// its lane 0
__device__ __forceinline__ void probe_add_form(unsigned long long* probe, int tid,
                                               uint32_t tiles, uint32_t fast) {
  if ((tid & 31) == 0) {
    atomicAdd(probe + kProbeFormTiles, (unsigned long long)tiles);
    atomicAdd(probe + kProbeFormFast, (unsigned long long)fast);
  }
}

}  // namespace idg
