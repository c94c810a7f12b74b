from .hash import NodePoolHashController
from .counter import NodePoolCounterController
from .readiness import NodePoolReadinessController
from .registrationhealth import NodePoolRegistrationHealthController
from .validation import NodePoolValidationController

__all__ = [
    "NodePoolHashController",
    "NodePoolCounterController",
    "NodePoolReadinessController",
    "NodePoolRegistrationHealthController",
    "NodePoolValidationController",
]
