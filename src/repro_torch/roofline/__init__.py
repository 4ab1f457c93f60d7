"""Roofline arithmetic of the port: cold-start runtime priors (``prior``)."""
