// Device marks: one thread stamps (mark id, %globaltimer) into a ring.
//
// The ring and its head are globals of this module, made when the module
// loads on a device (tfhe_marks_load), so no allocator holds them and a
// capture finds them in place.  A mark is launched on the caller's
// stream, so a CUDA graph captured on that stream holds it as a kernel
// node and every replay stamps again.  Each launch takes the next slot by
// an atomic add on the head (slot = head mod kSlots); the host keeps the
// same count by counting the launches that run (utils/profiling.py), so
// it knows which slots a replay wrote without a device read.  Entry i of
// the ring is two words: the mark's id, then the global timer in
// nanoseconds when the mark ran.

#include <cuda_runtime.h>

constexpr unsigned long long kSlots = 1ull << 16;   // 1 MiB

__device__ unsigned long long tfhe_ring[2 * kSlots];
__device__ unsigned long long tfhe_head;

extern "C" __global__ void tfhe_mark(unsigned long long id) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned long long slot = atomicAdd(&tfhe_head, 1ull) & (kSlots - 1);
  tfhe_ring[2 * slot] = id;
  tfhe_ring[2 * slot + 1] = t;
}

// The ring's entries.
extern "C" int tfhe_marks_slots() { return static_cast<int>(kSlots); }

// Loads this module on the current device (its ring and head, zeroed);
// returns the CUDA error code (0: none).  Never inside a capture.
extern "C" int tfhe_marks_load() {
  void* ring = nullptr;
  return static_cast<int>(cudaGetSymbolAddress(&ring, tfhe_ring));
}

// One mark on `stream`; returns the launch's CUDA error code.
extern "C" int tfhe_mark_launch(unsigned long long id, void* stream) {
  tfhe_mark<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(id);
  return static_cast<int>(cudaGetLastError());
}

// Copies the current device's ring (2 * kSlots words) to host memory at
// `dst` once the device's work is done; returns the CUDA error code.
extern "C" int tfhe_marks_read(void* dst) {
  cudaError_t rc = cudaDeviceSynchronize();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, tfhe_ring, sizeof(tfhe_ring)));
}
