// The transport of K5's and K6's rank mode between ranks (host code, no
// kernel): the counterpart of the TPU kernels' remote copies, credit
// semaphores and drain (src/repro/kernels/spm_stack.py `_rdma_descriptor`
// :1284, `_slot_reuse_guard` :1296, `_drain_epilogue` :1308).
//
// A channel is one cudaMalloc of a rank's own: two send slots, two receive
// slots and four 64-bit flag words (a data word and a credit word a slot).
// Its CUDA IPC handle goes to the partner rank, which opens it
// (cudaIpcOpenMemHandle, lazily enabling peer access): the partner's send
// kernel stores its block straight into this rank's receive slot, and its
// stream writes this rank's flag words.  A channel is made with the
// runtime's own allocator, never torch's caching allocator: an IPC handle
// names a whole allocation, and the caching allocator sub-allocates.
//
// Signals are sequence numbers that only grow.  The sender's stream writes
// the block's number into the partner's data word once its data is stored
// (cuStreamWriteValue64, which fences the stream's earlier work); the
// receiver's stream waits until its data word has reached the number
// (cuStreamWaitValue64, GEQ).  After the mix has read a receive slot, the
// receiver's stream writes the number into the sender's credit word, and
// the sender's stream waits on that before it rewrites the slot.  A stale
// flag from an earlier block or call is smaller and never satisfies a
// wait.  Every wait between ranks is in a stream, never in a spinning
// kernel: two ranks that share a card run in two contexts that the card
// time-slices, and a kernel spinning on its partner could hold the card
// from the partner's kernel for a whole slice.
//
// libcuda's stream memory operations are reached through the runtime's
// entry-point lookup (cudaGetDriverEntryPointByVersion), so that nothing
// links libcuda.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstring>

typedef CUresult (*StreamValue64)(CUstream, CUdeviceptr, cuuint64_t,
                                  unsigned int);
typedef CUresult (*DeviceAttribute)(int*, CUdevice_attribute, CUdevice);

static StreamValue64 g_wait = nullptr;
static StreamValue64 g_write = nullptr;

static void say(char* why, int len, const char* msg) {
  if (why && len > 0) {
    std::strncpy(why, msg, len - 1);
    why[len - 1] = 0;
  }
}

static bool entry(const char* symbol, void** fn) {
  cudaDriverEntryPointQueryResult q;
  return cudaGetDriverEntryPointByVersion(symbol, fn, 12000, cudaEnableDefault,
                                          &q) == cudaSuccess &&
         q == cudaDriverEntryPointSuccess && *fn != nullptr;
}

// Load the stream memory operations and check that the card supports 64-bit
// waits and writes.  Returns 0, or non-zero with the reason in `why`.
extern "C" int spm_peer_init(int device, char* why, int why_len) {
  void* attr = nullptr;
  if (!entry("cuDeviceGetAttribute", &attr) ||
      !entry("cuStreamWaitValue64", reinterpret_cast<void**>(&g_wait)) ||
      !entry("cuStreamWriteValue64", reinterpret_cast<void**>(&g_write))) {
    say(why, why_len,
        "libcuda has no cuStreamWaitValue64/cuStreamWriteValue64 entry "
        "point");
    return 1;
  }
  int mem64 = 0, nor = 0;
  DeviceAttribute get = reinterpret_cast<DeviceAttribute>(attr);
  if (get(&mem64, CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS,
          device) != CUDA_SUCCESS ||
      get(&nor, CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_WAIT_VALUE_NOR, device) !=
          CUDA_SUCCESS) {
    say(why, why_len, "cuDeviceGetAttribute failed");
    return 2;
  }
  if (!mem64) {
    say(why, why_len,
        "CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS is 0: the card "
        "has no 64-bit stream waits");
    return 3;
  }
  if (!nor) {
    say(why, why_len,
        "CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_WAIT_VALUE_NOR is 0: the card "
        "has no full stream memory operations");
    return 4;
  }
  return 0;
}

// A zeroed channel of `bytes` on the current device.
extern "C" int spm_peer_alloc(size_t bytes, void** ptr) {
  cudaError_t e = cudaMalloc(ptr, bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemset(*ptr, 0, bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}

// The 64-byte IPC handle of an allocation, into `out`.
extern "C" int spm_peer_handle(void* ptr, void* out) {
  cudaIpcMemHandle_t h;
  cudaError_t e = cudaIpcGetMemHandle(&h, ptr);
  if (e == cudaSuccess) std::memcpy(out, &h, sizeof(h));
  return (int)e;
}

extern "C" int spm_peer_handle_bytes() {
  return (int)sizeof(cudaIpcMemHandle_t);
}

// Open another process's allocation from its handle.
extern "C" int spm_peer_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

// In stream order: write `value` into the 64-bit word at `addr` once the
// stream's earlier work is done and visible (a signal or a credit).
extern "C" int spm_peer_signal(void* stream, void* addr,
                               unsigned long long value) {
  if (!g_write) return (int)CUDA_ERROR_NOT_INITIALIZED;
  return (int)g_write((CUstream)stream, (CUdeviceptr)addr, value,
                      CU_STREAM_WRITE_VALUE_DEFAULT);
}

// In stream order: hold the stream's later work until the 64-bit word at
// `addr` has reached `value` (the numbers only grow).
extern "C" int spm_peer_wait(void* stream, void* addr,
                             unsigned long long value) {
  if (!g_wait) return (int)CUDA_ERROR_NOT_INITIALIZED;
  return (int)g_wait((CUstream)stream, (CUdeviceptr)addr, value,
                     CU_STREAM_WAIT_VALUE_GEQ);
}

// The word at `addr` as the host sees it now (tests and the drain check).
extern "C" int spm_peer_read(void* addr, unsigned long long* value) {
  return (int)cudaMemcpy(value, addr, sizeof(*value), cudaMemcpyDeviceToHost);
}
