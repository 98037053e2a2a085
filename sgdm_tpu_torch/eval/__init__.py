"""Evaluation: the FID InceptionV3, FID / sFID / IS / PRDC, the FID engine,
validation FID and the test phase (`harness`)."""
