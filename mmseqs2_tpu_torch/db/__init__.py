from .dbtype import *  # noqa: F401,F403
from .reader import DBReader  # noqa: F401
from .writer import DBWriter  # noqa: F401
