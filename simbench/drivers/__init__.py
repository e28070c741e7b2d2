"""Traffic drivers, one file a traffic ``kind``: each reads a configuration
and a traffic mix (data files) and drives the port through one run."""
