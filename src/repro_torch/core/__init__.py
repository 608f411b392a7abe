"""Core of the port: geometry, planner, projectors, backends, executors."""
