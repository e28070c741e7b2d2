"""Steps 1-2 (AOIG → MIG → μProgram → lowered command trace) and the Step-3
execution seam."""
