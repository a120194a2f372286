"""Host networking helpers (port of areal_tpu/base/network.py)."""

import random
import socket


def find_free_port(low: int = 1, high: int = 65536) -> int:
    """A free TCP port; honors [low, high) when a restricted range is given."""
    if low <= 1 and high >= 65536:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind(("", 0))
            return s.getsockname()[1]
    ports = list(range(max(low, 1024), high))
    random.shuffle(ports)
    for port in ports:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind(("", port))
                return port
            except OSError:
                continue
    raise OSError(f"no free port in [{low}, {high})")


def gethostname() -> str:
    return socket.gethostname()


def gethostip() -> str:
    """This host's address as its own name resolves, else the loopback.
    (The JAX package asks the kernel for the route to a public address;
    the port resolves the host name and never names an outside host.)"""
    try:
        ip = socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind((ip, 0))  # an address of this host
    except OSError:
        return "127.0.0.1"
    return ip
