// CPU stand-in for cuda_bf16.h: bfloat16 as its 16 bits, converted with
// round to nearest even as the card's __float2bfloat16_rn does.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
    uint16_t x;
};
inline float __bfloat162float(__nv_bfloat16 v) {
    const uint32_t b = (uint32_t)v.x << 16;
    float f;
    std::memcpy(&f, &b, 4);
    return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
    uint32_t b;
    std::memcpy(&b, &f, 4);
    b += 0x7FFFu + ((b >> 16) & 1u);
    return {(uint16_t)(b >> 16)};
}

inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 v) { return v.x; }

struct __nv_bfloat162 {
    __nv_bfloat16 x, y;
};
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
    return {__float2bfloat16_rn(lo), __float2bfloat16_rn(hi)};
}
