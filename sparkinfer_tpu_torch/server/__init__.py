from .app import ServerConfig, SparkServer

__all__ = ["ServerConfig", "SparkServer"]
