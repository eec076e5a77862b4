"""Host-side native code of the port (ctypes bindings to ``native/*.cpp``)."""
