"""Fault-tolerance runtime: heartbeats, stragglers, elastic re-mesh,
supervisor (port of ``repro/runtime``)."""
from .fault_tolerance import (HeartbeatMonitor, StragglerDetector,
                              SupervisorConfig, TrainingSupervisor,
                              device_chips, plan_elastic_mesh)
