"""JVRC-1 (lower body): the frozen description in ../jvrc.py."""

from ..jvrc import jvrc_spec


def spec(**args):
    return jvrc_spec(**args)
