"""Training-side fault handling (the device-free part of ``repro.train``)."""
