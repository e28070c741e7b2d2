"""SIMDRAM substrate: DRAM timing/energy model, vertical-layout
transposition, control unit and the session-scoped machine."""
