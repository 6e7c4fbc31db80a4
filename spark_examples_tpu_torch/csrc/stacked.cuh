// The lanes of a stacked launch: K independent jobs (ops/batched.py) whose
// operands lie one after another in one tensor, one launch for all of them.
//
// A stacked kernel takes the lane from blockIdx.z. Where the launcher was
// given the lanes that hold work this step (`count` of them, at most
// STACK_LIST), blockIdx.z indexes that list, and the other lanes are not
// touched; else blockIdx.z is the lane. The list rides in the kernel's
// parameters (__grid_constant__, so an index into it reads the parameter
// space and copies nothing).

#pragma once

#include <cstdint>

constexpr int STACK_LIST = 512;  // lanes a launch lists: 1 KiB of its parameters

struct StackLanes {
  int count;  // 0: every lane, blockIdx.z the lane
  uint16_t lane[STACK_LIST];
};

__device__ __forceinline__ int stack_lane(const StackLanes& lanes) {
  return lanes.count ? lanes.lane[blockIdx.z] : static_cast<int>(blockIdx.z);
}

// Fills `out` from the host's `count` lanes, ascending and each below
// `total` (count 0: every lane), and sets z, the launch's gridDim.z. False
// for a list that does not fit, is out of order or names a lane past the
// stack.
inline bool stack_lanes(StackLanes* out, int total, const int* lanes, int count, int* z) {
  out->count = 0;
  *z = total;
  if (count == 0) return true;
  if (count < 0 || count > STACK_LIST || lanes == nullptr) return false;
  for (int i = 0; i < count; ++i) {
    if (lanes[i] < 0 || lanes[i] >= total || (i > 0 && lanes[i] <= lanes[i - 1])) return false;
    out->lane[i] = static_cast<uint16_t>(lanes[i]);
  }
  out->count = count;
  *z = count;
  return true;
}
