"""Native host kernels (C++ via ctypes) with numpy fallbacks."""
