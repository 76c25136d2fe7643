"""Pure-Python core of the port: contraction specs, schedules, cost model."""
