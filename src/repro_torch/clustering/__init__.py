from repro_torch.clustering.kmeans import kmeans, kmeans_assign, lloyd_step

__all__ = ["kmeans", "kmeans_assign", "lloyd_step"]
