// Row roll of an int8 tile for Hopper (sm_90a): out[i] = x[(i - shift) mod
// rows], the function np.roll(x, shift, 0) computes.
//
// Replaces the probe tools/r4_tpu_queue7.sh:14 (kern: pltpu.roll of one
// [32, 128] int8 tile by 30 along the sublane axis), which checked that the
// TPU's int8 sublane roll lowers; it lies on no path of the system.  What
// bounds it: bytes (each byte read once and written once), and at the
// probe's 4 KB, the launch.  Design: one thread per 16-byte piece of a row
// (a row of 128 bytes is 8 pieces), so a [32, 128] tile is one block of 256
// threads and each piece is one vector load and one vector store; the grid
// covers the pieces exactly and the index arithmetic is 32-bit, with the
// shift brought into [0, rows) on the host (no modulo in the kernel); rows
// whose width is not a multiple of 16 bytes, or a tile or output that does
// not start on a 16-byte boundary, move byte by byte.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void sublane_roll_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                                    int rows, int per_row, int cols, int shift, bool vec) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= rows * per_row) return;
  const int i = q / per_row, piece = q - i * per_row;
  const int src = i >= shift ? i - shift : i - shift + rows;
  if (vec) {
    reinterpret_cast<int4*>(out + i * cols)[piece] =
        reinterpret_cast<const int4*>(x + src * cols)[piece];
  } else {
    out[i * cols + piece] = x[src * cols + piece];
  }
}

}  // namespace

extern "C" const char* pl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, out: [rows][cols] int8, contiguous, rows * cols < 2^31; shift in
// [0, rows).  Runs on `stream` and returns the cudaGetLastError code (0 = ok).
extern "C" int sublane_roll_launch(const int8_t* x, int8_t* out, int rows, int cols, int shift,
                                   void* stream) {
  const bool vec = cols % 16 == 0 && ((uintptr_t)x | (uintptr_t)out) % 16 == 0;
  const int per_row = vec ? cols / 16 : cols;
  const int threads = 256;
  const int blocks = (rows * per_row + threads - 1) / threads;
  if (blocks == 0) return 0;  // an empty tile: nothing to move
  sublane_roll_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, rows, per_row, cols, shift, vec);
  return (int)cudaGetLastError();
}
