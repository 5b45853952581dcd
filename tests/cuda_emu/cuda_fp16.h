// CPU stand-in for cuda_fp16.h: float16 as its 16 bits, converted with
// round to nearest even as the card's __float2half_rn does (GCC's
// _Float16 converts in the current rounding mode, nearest even).
#pragma once
#include <cstdint>
#include <cstring>

struct __half {
    uint16_t x;
};
inline float __half2float(__half v) {
    _Float16 h;
    std::memcpy(&h, &v.x, 2);
    return (float)h;
}
inline __half __float2half_rn(float f) {
    const _Float16 h = (_Float16)f;
    __half v;
    std::memcpy(&v.x, &h, 2);
    return v;
}
