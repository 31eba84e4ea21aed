"""The plain reference that decides ``correct``: float32 torch (TF32 off)
and float64 numpy, written for this benchmark or frozen from the port's
plain code as of the benchmark's first version. It imports nothing of
gwkit_torch and takes nothing the port made: it reads the weight files and
the benchmark's own inputs and works out again what the port derives from
them (folded DoRA weights, the whitening filters, the Q-scan plan, the mel
bank)."""
