// Row roll of an int8 tile for Hopper (sm_90a): out[i] = x[(i - shift) mod
// rows], the function np.roll(x, shift, 0) computes.
//
// Replaces the probe tools/r4_tpu_queue7.sh:14 (kern: pltpu.roll of one
// [32, 128] int8 tile by 30 along the sublane axis), which checked that the
// TPU's int8 sublane roll lowers; it lies on no path of the system.  What
// bounds it: bytes (each byte read once and written once), and at the
// probe's 4 KB, the launch.  Design: one thread per 16-byte piece of a row
// (a row of 128 bytes is 8 pieces), so a [32, 128] tile is one block of 256
// threads and each piece is one vector load and one vector store; rows whose
// width is not a multiple of 16 bytes, or a tile or output that does not start
// on a 16-byte boundary, move byte by byte.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void sublane_roll_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                                    int rows, int cols, int shift, bool vec) {
  const int per_row = vec ? cols / 16 : cols;
  const long long total = (long long)rows * per_row;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < total;
       q += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(q / per_row), piece = (int)(q - (long long)i * per_row);
    const int src = ((i - shift) % rows + rows) % rows;
    if (vec) {
      reinterpret_cast<int4*>(out + (size_t)i * cols)[piece] =
          reinterpret_cast<const int4*>(x + (size_t)src * cols)[piece];
    } else {
      out[(size_t)i * cols + piece] = x[(size_t)src * cols + piece];
    }
  }
}

}  // namespace

extern "C" const char* pl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, out: [rows][cols] int8, contiguous; runs on `stream` and returns the
// cudaGetLastError code (0 = ok).
extern "C" int sublane_roll_launch(const int8_t* x, int8_t* out, int rows, int cols, int shift,
                                   void* stream) {
  const bool vec = cols % 16 == 0 && ((uintptr_t)x | (uintptr_t)out) % 16 == 0;
  const long long pieces = (long long)rows * (vec ? cols / 16 : cols);
  const int threads = 256;
  const int blocks = (int)((pieces + threads - 1) / threads < 1024 ? (pieces + threads - 1) / threads
                                                                   : 1024);
  sublane_roll_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(x, out, rows,
                                                                                 cols, shift, vec);
  return (int)cudaGetLastError();
}
