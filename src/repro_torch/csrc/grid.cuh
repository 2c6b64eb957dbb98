// Rows of a launch past grid y's 65,535 blocks. gather_distance,
// fused_expand and fused_expand_adc put their queries, and l2_matmul its
// corpus tiles, on grid y and then z, so grid x keeps its meaning and
// launch order (x fastest, then y, then z) and no kernel divides to find
// its row.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kGridY = 65535;

// The grid of `x` blocks per row over `rows` rows (rows >= 1).
inline dim3 rows_grid(unsigned x, long long rows) {
  return dim3(x, static_cast<unsigned>(rows < kGridY ? rows : kGridY),
              static_cast<unsigned>((rows + kGridY - 1) / kGridY));
}

// This block's row; rows_grid's last z slice holds rows >= the row count,
// which the kernel skips.
__device__ __forceinline__ long long grid_row() {
  return static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y;
}

}  // namespace repro_torch
