"""Anytime replanning services + path postprocessing (port of
`nfopp_tpu/service/`)."""

from .fleet import FleetReplanningService  # noqa: F401
from .postprocessor import PathPostprocessor  # noqa: F401
from .replanner import ReplanningService  # noqa: F401
from .session import (  # noqa: F401
    DynamicSessionAux,
    SessionAux,
    advance_along_path,
    dynamic_replan_session,
    fleet_dynamic_session,
    fleet_replan_session,
    replan_session,
    subfleet_generators,
)
from .world_state import RobotStateProvider, WorldState  # noqa: F401
