"""Host IO runtime: the native TS reader / IQ sink (csrc/tsio.cpp) and its
ctypes bindings."""
