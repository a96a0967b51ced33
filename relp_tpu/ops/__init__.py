"""Device arithmetic building blocks (double-float EFT arithmetic)."""
