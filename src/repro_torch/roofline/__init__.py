"""Analytic roofline model of one NVIDIA H100 (port of the kernel, AIRSHIP
and recsys parts of ``repro.roofline.model``)."""
