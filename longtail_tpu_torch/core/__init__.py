"""Folder indexing over the device data plane."""
