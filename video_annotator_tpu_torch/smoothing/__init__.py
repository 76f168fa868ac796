"""Camera-trajectory smoothing (Savitzky-Golay on SO(3))."""
