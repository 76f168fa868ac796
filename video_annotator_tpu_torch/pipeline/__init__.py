"""Two-phase analyse/encode render, trajectory store, profiler."""
