// Constants and helpers shared by the attention kernels (gat_attention.cu,
// gatv2_attention.cu): blocks of kWarpsPerBlock warps, one warp per row of
// a CSR or CSC, at most kMaxHeads heads and 256 floats per row.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxHeads = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEmptyMax = -1e30f;  // m of a receiver without in-edges

__device__ __forceinline__ float leaky(float z, float slope) {
  return z >= 0.f ? z : slope * z;
}

inline unsigned blocks_for(int n_rows) {
  return (unsigned)((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

inline bool shape_ok(int heads, int channels) {
  return heads >= 1 && heads <= kMaxHeads && channels >= 1 &&
         heads * channels <= 32 * 8;
}

}  // namespace
