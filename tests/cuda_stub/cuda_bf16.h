// Stand-in for cuda_bf16.h for the host syntax pass (see cuda_runtime.h).
#pragma once

#include <stdint.h>

struct __nv_bfloat16 {
  uint16_t bits;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};

float __bfloat162float(__nv_bfloat16);
__nv_bfloat16 __float2bfloat16_rn(float);
__nv_bfloat162 __floats2bfloat162_rn(float, float);
