// Shared helpers of the visual_odometry_tpu_torch kernels.
//
// Every kernel is exported through a plain C function that launches on the
// caller's stream and returns cudaGetLastError() as an int, so the Python
// wrapper (ops/kernels/_lib.py, bound with ctypes) can raise on a refused
// launch. The library is compiled with --fmad=false: no multiply-add is
// contracted, so each float expression rounds exactly like the same
// expression written as separate PyTorch ops in the plain versions.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define VO_EXPORT extern "C" __attribute__((visibility("default")))

static inline int vo_launch_status() { return static_cast<int>(cudaGetLastError()); }
