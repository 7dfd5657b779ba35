"""Host and device utilities of the port: platform, DSP, wav I/O."""
