// CPU stand-in for cuda.h: the driver API's tensor maps live beside the
// runtime's stand-in in cuda_runtime.h.
#pragma once
#include "cuda_runtime.h"
