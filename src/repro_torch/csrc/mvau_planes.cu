// The plane route's entry point of mvau.cu (repro_mvau_int_planes_conv),
// built as an object of its own beside mvau.cu's so that the two compile
// side by side (kernels/build.py starts one nvcc a source).  Functions of
// mvau.cu that this entry point does not reach are defined but unused here.
#pragma nv_diag_suppress 177
#define REPRO_MVAU_PLANES 1
#include "mvau.cu"
