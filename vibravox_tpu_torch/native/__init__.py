"""Host-side C++ kernels of the data pipeline (built with g++ at first use)."""
