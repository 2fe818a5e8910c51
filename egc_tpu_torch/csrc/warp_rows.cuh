// Constants and helpers shared by the attention kernels (gat_attention.cu,
// gatv2_attention.cu): blocks of kWarpsPerBlock warps, one warp per row of
// a CSR or CSC, at most kMaxHeads heads. The shapes they take are those
// whose edge-group geometry fits a warp (shape_ok, edge_groups.cuh).
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

}  // namespace
