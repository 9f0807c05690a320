"""Roofline terms of the dry run on H100 constants, and their report
(counterpart of ``repro/roofline``)."""
