// The plane route's entry point of mvau.cu (repro_mvau_int_planes_conv)
// with its uint8 and 16-bit kinds, built as an object of its own beside
// mvau.cu's and mvau_planes24.cu's so that the three compile side by side
// (kernels/build.py starts one nvcc a source).  Functions of mvau.cu that
// this entry point does not reach are defined but unused here.
#pragma nv_diag_suppress 177
#define REPRO_MVAU_PLANES 1
#include "mvau.cu"
