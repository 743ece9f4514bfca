"""Multi-device and multi-process work: the landmark-sharded bundle
adjustment (`dist_ba`) and the data-parallel front end (`dist_frontend`)."""
