// MMR ("mmgt record") loader: mmap-backed clip records + threaded
// window-sampling prefetcher.
//
// Native replacement for the reference's decord/torch DataLoader stack
// (src/dataset/talk_video.py random-window reads over mp4): training
// records are dense, mmap'd, and window slices are gathered by a C++
// thread pool into a bounded queue, so the Python trainer thread never
// blocks on IO/decode and the GIL is never held during gathers.
//
// File format MMR1:
//   magic "MMR1" | u32 n_fields
//   per field: u16 name_len | name | u8 dtype_code | u8 ndim | u64 shape[]
//              | u64 offset | u64 nbytes
//   payload (raw little-endian arrays, 64-byte aligned)
// dtype codes: 0=u8, 1=f16, 2=f32, 3=i32, 4=i64
//
// C API (ctypes-friendly): see extern "C" block at the bottom.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Field {
  std::string name;
  uint8_t dtype = 0;
  std::vector<uint64_t> shape;
  uint64_t offset = 0;
  uint64_t nbytes = 0;
  uint64_t itemsize() const {
    switch (dtype) {
      case 0: return 1;
      case 1: return 2;
      case 2: return 4;
      case 3: return 4;
      case 4: return 8;
    }
    return 1;
  }
  uint64_t frame_bytes() const {  // bytes per leading-dim slice
    uint64_t n = itemsize();
    for (size_t i = 1; i < shape.size(); ++i) n *= shape[i];
    return n;
  }
};

struct Record {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  std::vector<Field> fields;
  uint64_t frames = 0;  // leading dim of the first field

  const Field* find(const std::string& name) const {
    for (auto& f : fields)
      if (f.name == name) return &f;
    return nullptr;
  }

  bool open(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) return false;
    size = st.st_size;
    base = static_cast<const uint8_t*>(
        mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
    if (base == MAP_FAILED) return false;
    madvise(const_cast<uint8_t*>(base), size, MADV_WILLNEED);
    const uint8_t* p = base;
    if (size < 8 || memcmp(p, "MMR1", 4) != 0) return false;
    p += 4;
    uint32_t n;
    memcpy(&n, p, 4);
    p += 4;
    for (uint32_t i = 0; i < n; ++i) {
      Field f;
      uint16_t nl;
      memcpy(&nl, p, 2);
      p += 2;
      f.name.assign(reinterpret_cast<const char*>(p), nl);
      p += nl;
      f.dtype = *p++;
      uint8_t nd = *p++;
      f.shape.resize(nd);
      for (uint8_t d = 0; d < nd; ++d) {
        memcpy(&f.shape[d], p, 8);
        p += 8;
      }
      memcpy(&f.offset, p, 8);
      p += 8;
      memcpy(&f.nbytes, p, 8);
      p += 8;
      fields.push_back(std::move(f));
    }
    if (!fields.empty() && !fields[0].shape.empty())
      frames = fields[0].shape[0];
    return true;
  }

  ~Record() {
    if (base && base != MAP_FAILED)
      munmap(const_cast<uint8_t*>(base), size);
    if (fd >= 0) close(fd);
  }
};

// One prefetched sample: contiguous per-field window buffers.
struct Sample {
  std::vector<std::vector<uint8_t>> buffers;  // one per requested field
  int32_t clip = 0;
  int32_t start = 0;
  int32_t ref_frame = 0;
};

struct Loader {
  std::vector<std::unique_ptr<Record>> records;
  std::vector<std::string> field_names;
  int n_frames = 12;
  int margin = 2;

  std::deque<std::unique_ptr<Sample>> queue;
  size_t queue_cap = 8;
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  uint64_t seed = 0;

  void worker(int wid) {
    std::mt19937_64 rng(seed + 0x9e3779b97f4a7c15ULL * (wid + 1));
    while (!stop.load()) {
      auto s = std::make_unique<Sample>();
      // pick a clip with enough frames
      const Record* rec = nullptr;
      int clip = 0;
      for (int tries = 0; tries < 64 && !rec; ++tries) {
        clip = static_cast<int>(rng() % records.size());
        const Record* r = records[clip].get();
        if (static_cast<int>(r->frames) >= n_frames + 2 * margin + 1)
          rec = r;
      }
      if (!rec) return;  // no usable clips
      int lo = margin;
      int hi = static_cast<int>(rec->frames) - n_frames - margin;
      int start = lo + static_cast<int>(rng() % std::max(1, hi - lo));
      s->clip = clip;
      s->start = start;
      // reference frame outside the window
      int total = static_cast<int>(rec->frames);
      int ref;
      do {
        ref = static_cast<int>(rng() % total);
      } while (ref >= start && ref < start + n_frames && total > n_frames);
      s->ref_frame = ref;

      for (auto& name : field_names) {
        // "frames_ref" aliases the frames field, sampled at the ref frame
        const Field* f =
            rec->find(name == "frames_ref" ? "frames" : name);
        if (!f) {
          s->buffers.emplace_back();
          continue;
        }
        bool windowed = name != "frames_ref";
        uint64_t fb = f->frame_bytes();
        std::vector<uint8_t> buf;
        if (windowed) {
          buf.resize(fb * n_frames);
          memcpy(buf.data(), rec->base + f->offset + fb * start,
                 fb * n_frames);
        } else {
          buf.resize(fb);
          memcpy(buf.data(), rec->base + f->offset + fb * ref, fb);
        }
        s->buffers.push_back(std::move(buf));
      }

      std::unique_lock<std::mutex> lk(mu);
      cv_full.wait(lk, [&] { return queue.size() < queue_cap || stop; });
      if (stop) return;
      queue.push_back(std::move(s));
      cv_empty.notify_one();
    }
  }

  std::unique_ptr<Sample> next() {
    std::unique_lock<std::mutex> lk(mu);
    cv_empty.wait(lk, [&] { return !queue.empty() || stop; });
    if (queue.empty()) return nullptr;
    auto s = std::move(queue.front());
    queue.pop_front();
    cv_full.notify_one();
    return s;
  }
};

}  // namespace

extern "C" {

void* mmr_loader_create(const char** paths, int n_paths,
                        const char** fields, int n_fields, int n_frames,
                        int margin, uint64_t seed, int n_workers,
                        int queue_depth) {
  auto* l = new Loader();
  for (int i = 0; i < n_paths; ++i) {
    auto r = std::make_unique<Record>();
    if (r->open(paths[i])) l->records.push_back(std::move(r));
  }
  if (l->records.empty()) {
    delete l;
    return nullptr;
  }
  for (int i = 0; i < n_fields; ++i) l->field_names.emplace_back(fields[i]);
  l->n_frames = n_frames;
  l->margin = margin;
  l->seed = seed;
  l->queue_cap = queue_depth > 0 ? queue_depth : 8;
  int nw = n_workers > 0 ? n_workers : 2;
  for (int w = 0; w < nw; ++w)
    l->workers.emplace_back([l, w] { l->worker(w); });
  return l;
}

// Field geometry of record 0 (all records must agree for batching).
int mmr_loader_field_info(void* handle, int field_idx, uint64_t* shape_out,
                          int* ndim_out, int* dtype_out) {
  auto* l = static_cast<Loader*>(handle);
  if (field_idx >= static_cast<int>(l->field_names.size())) return -1;
  const std::string& fname = l->field_names[field_idx];
  const Field* f =
      l->records[0]->find(fname == "frames_ref" ? "frames" : fname);
  if (!f) return -1;
  *ndim_out = static_cast<int>(f->shape.size());
  *dtype_out = f->dtype;
  for (size_t i = 0; i < f->shape.size(); ++i) shape_out[i] = f->shape[i];
  return 0;
}

// Copy the next sample's field buffers into caller arrays (sized
// n_frames * frame_bytes, or 1 frame for "frames_ref"). Returns the
// window start frame, or -1 on shutdown.
int mmr_loader_next(void* handle, uint8_t** field_ptrs, int n_fields,
                    int32_t* clip_out, int32_t* ref_out) {
  auto* l = static_cast<Loader*>(handle);
  auto s = l->next();
  if (!s) return -1;
  for (int i = 0; i < n_fields && i < static_cast<int>(s->buffers.size());
       ++i) {
    if (!s->buffers[i].empty())
      memcpy(field_ptrs[i], s->buffers[i].data(), s->buffers[i].size());
  }
  if (clip_out) *clip_out = s->clip;
  if (ref_out) *ref_out = s->ref_frame;
  return s->start;
}

void mmr_loader_destroy(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  l->stop = true;
  l->cv_full.notify_all();
  l->cv_empty.notify_all();
  for (auto& t : l->workers) t.join();
  delete l;
}

}  // extern "C"
