"""Integer fixed-point core, calibration and the Table-2 recipe."""
