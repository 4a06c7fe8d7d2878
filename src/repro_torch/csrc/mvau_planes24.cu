// The plane route's kinds for activation codes of 17 to 24 bits
// (repro_mvau_int_planes24, reached through mvau_planes.cu's
// repro_mvau_int_planes_conv), built as an object of their own so that
// their four instantiations compile beside the other plane kinds
// (kernels/build.py starts one nvcc a source).  Functions of mvau.cu that
// these kinds do not reach are defined but unused here.
#pragma nv_diag_suppress 177
#define REPRO_MVAU_PLANES 1
#define REPRO_MVAU_PLANES24 1
#include "mvau.cu"
