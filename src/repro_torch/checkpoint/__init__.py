"""Checkpointing and fault tolerance (torch twin of ``repro.checkpoint``)."""
from .checkpointer import Checkpointer
from .fault_tolerance import (ElasticMeshPlan, HeartbeatMonitor,
                              StragglerPolicy, plan_elastic_remesh)

__all__ = ["Checkpointer", "ElasticMeshPlan", "HeartbeatMonitor",
           "StragglerPolicy", "plan_elastic_remesh"]
