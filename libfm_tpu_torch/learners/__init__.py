"""Learners: the MCMC/ALS vector engine (regression) and mini-batch SGD,
one device."""
