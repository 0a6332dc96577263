"""Token data for calibration and evaluation."""
