"""Host-side IO: y4m, synthetic and OpenCV sources and sinks, device feed."""
