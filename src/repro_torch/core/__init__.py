"""FED3R core of the port: statistics, ridge solve, NCM, calibration."""
