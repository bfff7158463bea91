// Device addresses of pinned host memory (the pinned-host NVM tier).
//
// The dual-pool decode, the KV append, the page checksum and the page
// gather/scatter read and write the pinned pool in place, through the
// device address CUDA maps for it.  This entry point asks for that
// address and reports failure instead of guessing: memory that is not
// page-locked and mapped has no device address, and the caller raises.
#include "common.cuh"

// *dev = device address of the pinned host allocation starting at host
EXPORT int host_device_pointer(void* host, void** dev) {
  const cudaError_t err = cudaHostGetDevicePointer(dev, host, 0);
  if (err != cudaSuccess) cudaGetLastError();  // clear: the caller raises
  return static_cast<int>(err);
}
